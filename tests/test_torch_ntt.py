"""The port's NTT (seal_tpu_torch.ops.ntt) against seal_tpu's, bit for bit.

On the CPU the port runs its plain PyTorch transforms; they are held against
seal_tpu's XLA route (ops/ntt.py) and its Pallas kernel in interpret mode
(ops/ntt_pallas.py), forward and inverse, lazy and not. The vectorised table
build is pinned against seal_tpu's pure-Python build. The CUDA kernel K1 is
held against the plain version on the card by test_torch_kernels_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from seal_tpu.ops import ntt as jntt
from seal_tpu.ops import ntt_pallas
from seal_tpu_torch.modulus import CoeffModulus
from seal_tpu_torch.ops import ntt


def _moduli(n, count=3):
    return [m.value for m in CoeffModulus.create(n, [30, 45, 60][:count])]


def _pair(a):
    a = np.asarray(a, dtype=np.uint64)
    return ((a & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (a >> np.uint64(32)).astype(np.uint32))


def _u64(pair):
    return (np.asarray(pair[0], dtype=np.uint64)
            | (np.asarray(pair[1], dtype=np.uint64) << np.uint64(32)))


def _input(n, factor, seed, batch=(), count=3):
    """Residues below factor·q per prime row, from a numpy seed."""
    rng = np.random.default_rng(seed)
    q = np.array(_moduli(n, count), dtype=np.uint64)[:, None]
    x = rng.integers(0, 1 << 62, batch + (len(q), n), dtype=np.int64).astype(np.uint64)
    x %= q * np.uint64(factor)
    x[..., :, 0] = q[:, 0] * np.uint64(factor) - np.uint64(1)
    return x


@pytest.mark.parametrize("log_n", [4, 8, 10, 15, 17])
def test_tables_match_python_build(log_n):
    for q in _moduli(1 << log_n):
        got = ntt.build_ntt_tables(log_n, q)
        want = jntt.build_ntt_tables(log_n, q)
        fwd = got[0].view(np.uint64).tolist()
        inv = got[2].view(np.uint64).tolist()
        assert fwd == list(want.root_powers)
        assert inv == list(want.inv_root_powers)
        assert got[1].view(np.uint64).tolist() == [(v << 64) // q for v in fwd]
        assert got[3].view(np.uint64).tolist() == [(v << 64) // q for v in inv]
        assert got[4] == (want.inv_degree, (want.inv_degree << 64) // q)
        assert got[5] == (want.inv_last_scaled, (want.inv_last_scaled << 64) // q)


@pytest.mark.parametrize("n", [256, 1024, 32768])
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_plain_matches_seal_tpu(n, lazy, direction):
    """Up to n = 32768 (two primes there), which the card runs in two
    passes: the tables and the plain path at that size are seal_tpu's."""
    log_n = n.bit_length() - 1
    count = 2 if n > 1024 else 3
    moduli = _moduli(n, count)
    x = _input(n, 4 if direction == "forward" else 2, seed=n + lazy, count=count)
    t = ntt.make_ntt_tables(log_n, moduli, "cpu")
    jt = jntt.build_device_tables(log_n, moduli, with_pallas=False)
    port = ntt.ntt_forward if direction == "forward" else ntt.ntt_inverse
    ref = jntt.ntt_forward if direction == "forward" else jntt.ntt_inverse
    got = port(torch.from_numpy(x.view(np.int64)), t, lazy).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, _u64(ref(_pair(x), jt, lazy=lazy)))


@pytest.mark.parametrize("n", [256, 1024])
def test_plain_matches_pallas_interpret(n):
    """Against the TPU kernel itself (interpret mode), batched [2, L, n]."""
    log_n = n.bit_length() - 1
    moduli = _moduli(n)
    t = ntt.make_ntt_tables(log_n, moduli, "cpu")
    pt = ntt_pallas.build_pallas_tables(log_n, moduli)
    x = _input(n, 1, seed=7, batch=(2,))
    fwd = ntt.ntt_forward(torch.from_numpy(x.view(np.int64)), t)
    np.testing.assert_array_equal(
        fwd.numpy().view(np.uint64),
        _u64(ntt_pallas.ntt_forward_pallas(_pair(x), pt, interpret=True)))
    y = fwd.numpy().view(np.uint64)
    inv = ntt.ntt_inverse(fwd, t)
    np.testing.assert_array_equal(
        inv.numpy().view(np.uint64),
        _u64(ntt_pallas.ntt_inverse_pallas(_pair(y), pt, interpret=True)))
    np.testing.assert_array_equal(inv.numpy().view(np.uint64), x)


@pytest.mark.parametrize("log_n", [6, 8])
def test_compact_table_kernel_matches_port(log_n):
    """K4, seal_tpu's _ntt_kernel_compact (per-stage distinct roots, in
    interpret mode), against the port's transforms, whose kernel K1 reads
    the same roots in the same order: forward stage s uses
    root_powers[2^s : 2^(s+1)], inverse the consecutive blocks of
    inv_root_powers from offset 1, then the folded n^{-1} pair."""
    n = 1 << log_n
    moduli = [m.value for m in CoeffModulus.create(n, [30, 45])]
    t = ntt.make_ntt_tables(log_n, moduli, "cpu")
    pt = ntt_pallas.build_pallas_tables_compact(log_n, moduli)
    rng = np.random.default_rng(log_n)
    x = np.stack([rng.integers(0, q, n, dtype=np.int64) for q in moduli]).astype(np.uint64)
    fwd = ntt.ntt_forward_plain(torch.from_numpy(x.view(np.int64)), t)
    np.testing.assert_array_equal(
        fwd.numpy().view(np.uint64),
        _u64(ntt_pallas.ntt_forward_pallas(_pair(x), pt, interpret=True)))
    inv = ntt.ntt_inverse_plain(fwd, t)
    np.testing.assert_array_equal(
        inv.numpy().view(np.uint64),
        _u64(ntt_pallas.ntt_inverse_pallas(_pair(fwd.numpy().view(np.uint64)), pt,
                                           interpret=True)))
    np.testing.assert_array_equal(inv.numpy().view(np.uint64), x)


def test_lazy_ranges_and_round_trip():
    n, log_n = 1024, 10
    moduli = _moduli(n)
    q = torch.tensor(moduli, dtype=torch.int64)[:, None]
    t = ntt.make_ntt_tables(log_n, moduli, "cpu")
    x = torch.from_numpy(_input(n, 1, seed=3).view(np.int64))
    lazy = ntt.ntt_forward(x, t, lazy=True)
    assert bool((lazy < 4 * q).all()) and bool((lazy >= 0).all())
    full = ntt.ntt_forward(x, t)
    assert torch.equal(lazy % q, full)
    back = ntt.ntt_inverse(full, t, lazy=True)
    assert bool((back < 2 * q).all())
    assert torch.equal(back % q, x)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A CPU tensor reaches the plain version only through the dispatcher;
    the kernel wrappers never fall back to it."""
    n, log_n = 256, 8
    t = ntt.make_ntt_tables(log_n, _moduli(n), "cpu")
    x = torch.zeros((3, n), dtype=torch.int64)
    for wrapper in (ntt.ntt_forward_cuda, ntt.ntt_inverse_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(x, t)


def test_shape_mismatch_raises():
    t = ntt.make_ntt_tables(8, _moduli(256), "cpu")
    with pytest.raises(ValueError, match="does not match"):
        ntt.ntt_forward(torch.zeros((2, 256), dtype=torch.int64), t)

