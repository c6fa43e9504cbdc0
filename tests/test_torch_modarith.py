"""seal_tpu_torch.ops.modarith against seal_tpu.ops.limb, bit for bit.

The port keeps each uint64 word in one int64 tensor; seal_tpu keeps it as a
(lo, hi) pair of uint32 arrays. Both must give the same bits on random
inputs and on the range edges q-1, 2q-1, 4q-1, with 60-bit moduli among the
primes.
"""

import numpy as np
import pytest
import torch

from seal_tpu.ops import limb
from seal_tpu_torch.modulus import CoeffModulus
from seal_tpu_torch.ops import modarith

MASK64 = (1 << 64) - 1
PRIMES = [m.value for m in CoeffModulus.create(1024, [30, 44, 50, 60])]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def _pair(a):
    a = np.asarray(a, dtype=np.uint64)
    return ((a & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (a >> np.uint64(32)).astype(np.uint32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint64)
    return np.asarray(x[0], dtype=np.uint64) | (np.asarray(x[1], dtype=np.uint64) << np.uint64(32))


def _case(seed, cols=257):
    """Rows per prime: random values below q, then the edges."""
    rng = np.random.default_rng(seed)
    q = np.array(PRIMES, dtype=np.uint64)[:, None]
    below_q = rng.integers(0, np.iinfo(np.int64).max, (len(PRIMES), cols),
                           dtype=np.int64).astype(np.uint64) % q
    below_q[:, 0] = q[:, 0] - np.uint64(1)
    below_q[:, 1] = 0
    return q, below_q


def _consts(q):
    ratios = [(1 << 128) // int(v) for v in q[:, 0]]
    r0 = np.array([[r & MASK64] for r in ratios], dtype=np.uint64)
    r1 = np.array([[r >> 64] for r in ratios], dtype=np.uint64)
    return r0, r1


@pytest.mark.parametrize("op", ["add_mod", "sub_mod"])
def test_add_sub_mod(op):
    q, a = _case(1)
    _, b = _case(2)
    b[:, 2] = q[:, 0] - np.uint64(1)
    got = getattr(modarith, op)(_t(a), _t(b), _t(q))
    want = getattr(limb, op)(_pair(a), _pair(b), _pair(q))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_neg_mod():
    q, a = _case(3)
    np.testing.assert_array_equal(
        _np(modarith.neg_mod(_t(a), _t(q))), _np(limb.neg_mod(_pair(a), _pair(q))))


def test_cond_sub_u64():
    """Unsigned order across 2^63: sums and multiples q·2^s of 60- and
    61-bit moduli that are negative as int64, against limb.cond_sub."""
    rng = np.random.default_rng(6)
    q = np.array([[(1 << 61) - 1], [PRIMES[-1] << 3], [PRIMES[-1] << 2], [PRIMES[0]]],
                 dtype=np.uint64)
    a = rng.integers(0, 1 << 64, (4, 257), dtype=np.uint64)
    a[:, 0], a[:, 1], a[:, 2] = q[:, 0], q[:, 0] - np.uint64(1), np.uint64(MASK64)
    got = modarith.cond_sub_u64(_t(a), _t(q))
    np.testing.assert_array_equal(_np(got), _np(limb.cond_sub(_pair(a), _pair(q))))
    np.testing.assert_array_equal(_np(got), np.where(a >= q, a - q, a))


@pytest.mark.parametrize("full_width", [False, True])
def test_barrett_reduce_64(full_width):
    """Any u64 input, including words at and above 2^63."""
    rng = np.random.default_rng(4)
    q, _ = _case(4)
    _, r1 = _consts(q)
    if full_width:
        x = rng.integers(0, 1 << 63, q.shape[:1] + (257,), dtype=np.int64).astype(np.uint64)
        x = x * np.uint64(2) + np.uint64(1)
        x[:, 0] = np.uint64(MASK64)
    else:
        x = rng.integers(0, 1 << 62, (len(PRIMES), 257), dtype=np.int64).astype(np.uint64)
        x[:, 0] = np.uint64(4) * q[:, 0] - np.uint64(1)
        x[:, 1] = np.uint64(2) * q[:, 0] - np.uint64(1)
    got = modarith.barrett_reduce_64(_t(x), _t(q), _t(r1))
    want = limb.barrett_reduce_64(_pair(x), _pair(q), _pair(r1))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_barrett_reduce_128_and_mul_mod():
    q, a = _case(5)
    _, b = _case(6)
    r0, r1 = _consts(q)
    got = modarith.mul_mod(_t(a), _t(b), _t(q), _t(r0), _t(r1))
    want = limb.mul_mod(_pair(a), _pair(b), _pair(q), _pair(r0), _pair(r1))
    np.testing.assert_array_equal(_np(got), _np(want))
    # a 128-bit value with a high word near the top of the range (sums of
    # up to 64 products of 61-bit words)
    rng = np.random.default_rng(7)
    lo = rng.integers(0, 1 << 63, a.shape, dtype=np.int64).astype(np.uint64) << np.uint64(1)
    hi = rng.integers(0, 1 << 58, a.shape, dtype=np.int64).astype(np.uint64)
    got = modarith.barrett_reduce_128(_t(lo), _t(hi), _t(q), _t(r0), _t(r1))
    want = limb.barrett_reduce_128(_pair(lo), _pair(hi), _pair(q), _pair(r0), _pair(r1))
    np.testing.assert_array_equal(_np(got), _np(want))
    exact = [[((int(h) << 64) | int(lv)) % int(q[i, 0]) for lv, h in zip(lo[i], hi[i])]
             for i in range(len(PRIMES))]
    np.testing.assert_array_equal(_np(got), np.array(exact, dtype=np.uint64))


@pytest.mark.parametrize("lazy", [True, False])
def test_mul_mod_shoup(lazy):
    q, y = _case(8)
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1 << 63, y.shape, dtype=np.int64).astype(np.uint64)
    x[:, 0] = np.uint64(4) * q[:, 0] - np.uint64(1)
    x[:, 1] = np.uint64(2) * q[:, 0] - np.uint64(1)
    quot = np.array([[(int(v) << 64) // int(q[i, 0]) for v in y[i]]
                     for i in range(len(PRIMES))], dtype=np.uint64)
    fn = "mul_mod_shoup_lazy" if lazy else "mul_mod_shoup"
    got = getattr(modarith, fn)(_t(x), _t(y), _t(quot), _t(q))
    want = getattr(limb, fn)(_pair(x), _pair(y), _pair(quot), _pair(q))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_shoup_quotient():
    q, y = _case(10)
    r0, r1 = _consts(q)
    got = modarith.shoup_quotient(_t(y), _t(q), _t(r0), _t(r1))
    want = limb.shoup_quotient(_pair(y), _pair(q), _pair(r0), _pair(r1))
    np.testing.assert_array_equal(_np(got), _np(want))
    exact = [[(int(v) << 64) // int(q[i, 0]) for v in y[i]] for i in range(len(PRIMES))]
    np.testing.assert_array_equal(_np(got), np.array(exact, dtype=np.uint64))


def test_mul_add_128():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 61, (16, 64), dtype=np.int64).astype(np.uint64)
    b = rng.integers(0, 1 << 61, (16, 64), dtype=np.int64).astype(np.uint64)
    acc_t = (torch.zeros(64, dtype=torch.int64), torch.zeros(64, dtype=torch.int64))
    z = np.zeros(64, dtype=np.uint32)
    acc_l = (z, z, z, z)
    for j in range(16):
        acc_t = modarith.mul_add_128(acc_t, _t(a[j]), _t(b[j]))
        acc_l = limb.mul_add_128(acc_l, _pair(a[j]), _pair(b[j]))
    np.testing.assert_array_equal(_np(acc_t[0]), _np((acc_l[0], acc_l[1])))
    np.testing.assert_array_equal(_np(acc_t[1]), _np((acc_l[2], acc_l[3])))
