"""The port's key-switch inner product against seal_tpu's Pallas kernel and
exact Python ints, bit for bit (mirrors tests/test_keyswitch_pallas.py).

On the CPU the port runs its plain PyTorch version (128-bit lazy sum, one
Barrett-128); seal_tpu's kernel runs in interpret mode. The CUDA kernel K2
is held against the plain version on the card by test_torch_kernels_cuda.py
and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from seal_tpu.ops import keyswitch_pallas as ksp
from seal_tpu_torch.modulus import CoeffModulus
from seal_tpu_torch.ops import keyswitch


def _case(J, I, n, seed=0):
    rng = np.random.default_rng(seed)
    moduli = [m.value for m in CoeffModulus.create(max(n, 1024), [50] * I)]
    t = rng.integers(0, 1 << 61, size=(J, I, n), dtype=np.int64).astype(np.uint64)
    k = rng.integers(0, 1 << 61, size=(J, 2, I, n), dtype=np.int64).astype(np.uint64)
    return moduli, t, k


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _pair(a):
    return ((a & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (a >> np.uint64(32)).astype(np.uint32))


@pytest.mark.parametrize("J,I,n", [(3, 4, 256), (8, 9, 256)])
def test_plain_matches_pallas_and_exact(J, I, n):
    moduli, t, k = _case(J, I, n)
    got = keyswitch.keyswitch_inner(
        _t(t), _t(k), keyswitch.pack_mod_consts(moduli, "cpu")).numpy().view(np.uint64)

    lo, hi = ksp.keyswitch_inner_pallas(
        _pair(t), _pair(k), ksp.pack_mod_consts(moduli), interpret=True)
    pallas = np.asarray(lo, dtype=np.uint64) | (np.asarray(hi, dtype=np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(got, pallas)

    ti, ki = t.astype(object), k.astype(object)
    exact = np.zeros((2, I, n), dtype=np.uint64)
    for c in range(2):
        for i in range(I):
            acc = sum(ti[j, i] * ki[j, c, i] for j in range(J))
            exact[c, i] = [int(v) % moduli[i] for v in acc]
    np.testing.assert_array_equal(got, exact)


def test_pack_mod_consts_matches_seal_tpu():
    moduli = [m.value for m in CoeffModulus.create(1024, [44, 50, 60])]
    packed = keyswitch.pack_mod_consts(moduli, "cpu").numpy().view(np.uint64)
    words = ksp.pack_mod_consts(moduli).astype(np.uint64)
    np.testing.assert_array_equal(packed, words[:, 0::2] | (words[:, 1::2] << np.uint64(32)))


def test_term_count_and_device_checks():
    moduli, t, k = _case(2, 3, 64)
    consts = keyswitch.pack_mod_consts(moduli, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        keyswitch.keyswitch_inner_cuda(_t(t), _t(k), consts)
    with pytest.raises(ValueError, match="do not agree"):
        keyswitch.keyswitch_inner(_t(t), _t(k[:, :, :2]), consts)
    big = torch.zeros((keyswitch.MAX_TERMS + 1, 3, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="terms"):
        keyswitch.keyswitch_inner(big, torch.zeros((65, 2, 3, 64), dtype=torch.int64), consts)

