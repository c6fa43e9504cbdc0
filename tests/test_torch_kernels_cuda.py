"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and nvcc: it carries the `cuda` marker
and skips without a card. The file imports neither JAX nor seal_tpu, so it
also runs on a machine without them, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

import seal_tpu_torch as st
from seal_tpu_torch import cuda
from seal_tpu_torch.modulus import CoeffModulus
from seal_tpu_torch.ops import keyswitch, ntt

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")


def _residues(shape, moduli, factor, seed):
    """Residues below factor·q of each row's prime, with factor·q - 1 and
    q - 1 in the first two words of every row."""
    rng = np.random.default_rng(seed)
    q1 = np.array(moduli, dtype=np.uint64)[:, None]
    q = q1 * np.uint64(factor)
    x = rng.integers(0, 1 << 62, shape, dtype=np.int64).astype(np.uint64) % q
    x[..., :, 0] = q[:, 0] - np.uint64(1)
    x[..., :, 1] = q1[:, 0] - np.uint64(1)
    return torch.from_numpy(x.view(np.int64))


_NTT_BITS = [30, 50, 60, 40, 45, 55, 35, 58]


def _ntt_moduli(n, count):
    from seal_tpu_torch.utils import numth

    return [numth.get_primes(2 * max(n, 64), bits, 1)[0] for bits in _NTT_BITS[:count]]


# rows 1, 2, 3 as one tower of that many primes, at every log n (each
# one-pass size and each split of the two passes); 56 as [7, 8, n], the
# largest forward of the main path, at some of them. 56 rows at n = 2^17 is
# left out (the plain version takes too long there).
_NTT_SIZES = [(log_n, rows) for log_n in range(1, 18) for rows in (1, 2, 3)] + \
             [(log_n, 56) for log_n in (1, 2, 6, 10, 11, 12, 14, 15)]


@pytest.mark.parametrize("log_n,rows", _NTT_SIZES)
@pytest.mark.parametrize("direction,factor", [("forward", 4), ("inverse", 2)])
def test_ntt_kernel_matches_plain(log_n, rows, direction, factor):
    n = 1 << log_n
    shape = (7, 8, n) if rows == 56 else (rows, n)
    moduli = _ntt_moduli(n, shape[-2])
    t_cpu = ntt.make_ntt_tables(log_n, moduli, "cpu")
    t_dev = ntt.make_ntt_tables(log_n, moduli, "cuda")
    x = _residues(shape, moduli, factor, seed=n + rows)
    for lazy in (False, True):
        plain = getattr(ntt, f"ntt_{direction}_plain")(x, t_cpu, lazy)
        kernel = getattr(ntt, f"ntt_{direction}_cuda")(x.cuda(), t_dev, lazy)
        torch.cuda.synchronize()
        assert torch.equal(kernel.cpu(), plain)


@pytest.mark.parametrize("log_n", [15, 17])
def test_ntt_dispatch_runs_large_n_through_the_kernel(log_n):
    """n = 32768 and 131072, which the one-block-per-row kernel refused, go
    through the kernel: one count per transform, the plain version's bits."""
    n = 1 << log_n
    moduli = _ntt_moduli(n, 2)
    t_dev = ntt.make_ntt_tables(log_n, moduli, "cuda")
    t_cpu = ntt.make_ntt_tables(log_n, moduli, "cpu")
    x = _residues((2, n), moduli, 2, seed=log_n)
    before = dict(cuda.launches)
    fwd = ntt.ntt_forward(x.cuda(), t_dev)
    assert cuda.launches["ntt_forward"] == before["ntt_forward"] + 1
    back = ntt.ntt_inverse(fwd, t_dev)
    assert cuda.launches["ntt_inverse"] == before["ntt_inverse"] + 1
    want = ntt.ntt_forward_plain(x, t_cpu)
    assert torch.equal(fwd.cpu(), want)
    assert torch.equal(back.cpu(), ntt.ntt_inverse_plain(want, t_cpu))
    assert torch.equal(back.cpu(), x % torch.tensor(moduli).reshape(2, 1))


@pytest.mark.parametrize("J,I,n", [(1, 1, 64), (8, 9, 16384), (4, 10, 16384), (64, 2, 256)])
def test_keyswitch_kernel_matches_plain(J, I, n):
    """Inputs up to 2^61 and J up to the 64 terms the 128-bit sum holds."""
    rng = np.random.default_rng(J * 100 + I)
    moduli = [m.value for m in CoeffModulus.create(max(n, 1024), [60] * I)]
    t = rng.integers(0, 1 << 61, (J, I, n), dtype=np.int64)
    k = rng.integers(0, 1 << 61, (J, 2, I, n), dtype=np.int64)
    t[..., 0] = k[..., 0] = (1 << 61) - 1
    t, k = torch.from_numpy(t), torch.from_numpy(k)
    consts = keyswitch.pack_mod_consts(moduli, "cpu")
    plain = keyswitch.keyswitch_inner_plain(t, k, consts)
    kernel = keyswitch.keyswitch_inner(t.cuda(), k.cuda(), consts.cuda())
    assert torch.equal(kernel.cpu(), plain)


@pytest.mark.parametrize("J,I,n", [(1, 1, 64), (8, 9, 16384), (4, 10, 16384), (15, 17, 256)])
def test_keyswitch_shoup_kernel_matches_plain_and_k2(J, I, n):
    """K3 against its plain version and against K2. t and k reach q - 1,
    and keys at q - 1 have quotients with the top bit set; 2·J·max q stays
    below 2^64 (54-bit moduli, J <= 15)."""
    rng = np.random.default_rng(J * 100 + I + 7)
    moduli = [m.value for m in CoeffModulus.create(max(n, 1024), [54] * I)]
    q = np.array(moduli, dtype=np.int64)[:, None]
    t = rng.integers(0, q, (J, I, n), dtype=np.int64)
    k = rng.integers(0, q, (J, 2, I, n), dtype=np.int64)
    t[..., 0] = k[..., 0] = k[..., 1] = q[:, 0] - 1
    t, k = torch.from_numpy(t), torch.from_numpy(k)
    kq = keyswitch.key_quotients(k, moduli)
    assert bool((kq[..., 0] < 0).all())
    consts = keyswitch.pack_mod_consts(moduli, "cpu")
    plain = keyswitch.keyswitch_inner_shoup_plain(t, k, kq, consts, max(moduli))
    before = cuda.launches["keyswitch_inner_shoup"]
    kernel = keyswitch.keyswitch_inner_shoup(
        t.cuda(), k.cuda(), kq.cuda(), consts.cuda(), max(moduli))
    assert cuda.launches["keyswitch_inner_shoup"] == before + 1
    assert torch.equal(kernel.cpu(), plain)
    assert torch.equal(kernel, keyswitch.keyswitch_inner(t.cuda(), k.cuda(), consts.cuda()))
    kq_dev = keyswitch.key_quotients(k.cuda(), moduli)
    assert torch.equal(kq_dev.cpu(), kq)


@pytest.mark.parametrize("J,bits,n", [(7, 60, 16384), (8, 60, 4096), (3, 61, 4096)])
def test_keyswitch_shoup_kernel_matches_plain_past_2_63(J, bits, n):
    """t spans all 64 bits, so lazy sums (and, with 61-bit q, q·2^2) pass
    2^63; the kernel compares unsigned, and so must the plain version."""
    from seal_tpu_torch.utils import numth

    I = 2
    moduli = numth.get_primes(2 * n, bits, I)
    rng = np.random.default_rng(J * 100 + bits)
    t = torch.from_numpy(rng.integers(0, 1 << 64, (J, I, n), dtype=np.uint64).view(np.int64))
    q = np.array(moduli, dtype=np.int64)[:, None]
    k = torch.from_numpy(rng.integers(0, q, (J, 2, I, n), dtype=np.int64))
    kq = keyswitch.key_quotients(k, moduli)
    consts = keyswitch.pack_mod_consts(moduli, "cpu")
    plain = keyswitch.keyswitch_inner_shoup_plain(t, k, kq, consts, max(moduli))
    kernel = keyswitch.keyswitch_inner_shoup(
        t.cuda(), k.cuda(), kq.cuda(), consts.cuda(), max(moduli))
    assert torch.equal(kernel.cpu(), plain)
    assert bool(((plain >= 0) & (plain < torch.from_numpy(q))).all())


def test_keyswitch_shoup_kernel_refuses_overflow():
    moduli = [m.value for m in CoeffModulus.create(1024, [60])]
    consts = keyswitch.pack_mod_consts(moduli, "cuda")
    t = torch.zeros((16, 1, 64), dtype=torch.int64, device="cuda")
    k = torch.zeros((16, 2, 1, 64), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="2·J·max q"):
        keyswitch.keyswitch_inner_shoup(t, k, k, consts, max(moduli))


@pytest.mark.parametrize("alpha,bits", [(1, [50] * 4 + [60]), (2, [50] * 4 + [55] * 2)])
def test_rotations_on_card_match_cpu(alpha, bits):
    """rotate_vector (with the NAF fallback), complex_conjugate and both
    hoisted branches at n = 1024, with the Shoup flag off and on: the
    card's bits equal the plain path's, and the flag changes no bit."""
    from seal_tpu_torch import interop
    from seal_tpu_torch.config import config

    n = 1024
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
    parms.set_special_modulus_size(alpha)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE)
    cpu = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    gen = torch.Generator(device="cuda").manual_seed(alpha)
    kg = st.KeyGenerator(ctx, gen)
    steps = list(range(1, 18))
    gk = kg.create_galois_keys(steps=steps + [0])
    cd = ctx.first_context_data()
    plain = st.Plaintext(ntt.ntt_forward(
        torch.randint(0, 1 << 20, (cd.coeff_modulus_size, n), device="cuda", generator=gen),
        cd.ntt_tables), tuple(cd.parms_id), 2.0 ** 30)
    ct = st.Encryptor(ctx, kg.secret_key(), gen).encrypt_symmetric(plain)
    ct_cpu = interop.ciphertext_from_numpy(cpu, ct.to_numpy(), ct.parms_id, ct.scale)
    gk_cpu = interop.galois_keys_from_numpy(
        cpu, [None if k is None else k.cpu().numpy().view(np.uint64) for k in gk.keys])

    def run(ev, keys, c):
        outs = [ev.rotate_vector(c, 18, keys), ev.complex_conjugate(c, keys)]
        outs += ev.rotate_batch_hoisted(c, [3, 7], keys)
        outs += ev.rotate_batch_hoisted(c, steps, keys)
        return [o.to_numpy() for o in outs]

    old = config.keyswitch_shoup
    try:
        got = {}
        for shoup in (False, True):
            config.keyswitch_shoup = shoup
            before = cuda.launches["keyswitch_inner_shoup"]
            got[shoup] = run(st.Evaluator(ctx), gk, ct)
            assert (cuda.launches["keyswitch_inner_shoup"] > before) == shoup
        config.keyswitch_shoup = False
        want = run(st.Evaluator(cpu), gk_cpu, ct_cpu)
    finally:
        config.keyswitch_shoup = old
    for a, b, c in zip(got[False], got[True], want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


@pytest.mark.parametrize("alpha,bits,n", [(1, [50] * 4 + [60], 1024),
                                          (2, [50] * 4 + [55] * 2, 1024),
                                          (1, [50] * 3 + [60], 32768)])
def test_pipeline_on_card_matches_cpu(alpha, bits, n):
    """multiply -> relinearize -> rescale and the fused tail at n = 1024,
    and at n = 32768 with 4 primes (two-pass transforms on the card): the
    card's bits equal the plain path's on the same keys and inputs."""
    from seal_tpu_torch import interop

    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
    parms.set_special_modulus_size(alpha)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE)
    cpu = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    gen = torch.Generator(device="cuda").manual_seed(alpha)
    kg = st.KeyGenerator(ctx, gen)
    rk = kg.create_relin_keys()
    enc = st.Encryptor(ctx, kg.secret_key(), gen)
    cd = ctx.first_context_data()
    plain = st.Plaintext(ntt.ntt_forward(
        torch.randint(0, 1 << 20, (cd.coeff_modulus_size, n), device="cuda", generator=gen),
        cd.ntt_tables), tuple(cd.parms_id), 2.0 ** 30)
    cts = [enc.encrypt_symmetric(plain) for _ in range(2)]
    carried = [interop.ciphertext_from_numpy(cpu, c.to_numpy(), c.parms_id, c.scale)
               for c in cts]
    rk_cpu = interop.relin_keys_from_numpy(cpu, [k.cpu().numpy().view(np.uint64)
                                                 for k in rk.keys])
    for ev, (a, b), keys in ((st.Evaluator(ctx), cts, rk), (st.Evaluator(cpu), carried, rk_cpu)):
        mul = ev.multiply(a, b)
        out = [ev.rescale_to_next(ev.relinearize(mul, keys)), ev.relinearize_rescale(mul, keys)]
        if ev.context is ctx:
            got = [o.to_numpy() for o in out]
        else:
            want = [o.to_numpy() for o in out]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
