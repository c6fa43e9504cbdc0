"""SEAL's polyarithsmallmod functions on the port (ops/modring.py:
multiply_poly_scalar, modulo_poly_coeffs, negacyclic_shift_poly,
negacyclic_multiply_mono, poly_infty_norm) against seal_tpu's
(seal_tpu/ops/modring.py), bit for bit (tolerance 0), at n = 64 and 1024 on
towers of two and three primes of 30 to 60 bits.

Inputs are random residues from numpy.random.default_rng(seed), with 0,
1 and q - 1 in the first words of every row; modulo_poly_coeffs takes
arbitrary 64-bit words. Shifts and exponents run over 0, 1, n - 1, n and
2n - 1: the last two are outside [0, n), which both packages refuse with
a ValueError. poly_infty_norm is compared as Python ints. seal_tpu's
functions run eagerly on its (lo, hi) uint32 limb pairs (no jit).
"""

import numpy as np
import pytest
import torch

from seal_tpu.ops import modring as jmodring
from seal_tpu_torch.modulus import CoeffModulus
from seal_tpu_torch.ops import modring

TOWERS = {64: [[30, 60], [40, 50, 60]], 1024: [[60, 45], [30, 40, 60]]}
CASES = [(n, i) for n, towers in TOWERS.items() for i in range(len(towers))]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tower(n, i):
    return [m.value for m in CoeffModulus.create(n, TOWERS[n][i])]


def _residues(n, qs, seed, batch=()):
    rng = np.random.default_rng(seed)
    q = np.array(qs, dtype=np.uint64)[:, None]
    x = rng.integers(0, 1 << 63, batch + (len(qs), n), dtype=np.uint64) % q
    x[..., 0], x[..., 1], x[..., 2] = 0, 1, q[:, 0] - np.uint64(1)
    return x


def _pair(x):
    x = np.asarray(x, dtype=np.uint64)
    return ((x & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (x >> np.uint64(32)).astype(np.uint32))


def _u64(pair):
    return (np.asarray(pair[0], dtype=np.uint64)
            | (np.asarray(pair[1], dtype=np.uint64) << np.uint64(32)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


def _np(t):
    return t.numpy().view(np.uint64)


def _consts(qs):
    return modring.make_mod_consts(qs, "cpu"), jmodring.make_mod_consts(qs)


def _scalar(qs, value):
    values, moduli = [[value % q] for q in qs], [[q] for q in qs]
    return modring.shoup_pair(values, moduli, "cpu"), jmodring.shoup_pair(values, moduli)


@pytest.mark.parametrize("n,tower", CASES)
def test_multiply_poly_scalar(n, tower):
    qs = _tower(n, tower)
    mc, jmc = _consts(qs)
    x = _residues(n, qs, seed=n + tower, batch=(2,))
    for value in (0, 1, 3, (1 << 64) - 1, 0x123456789ABCDEF):
        (op, qt), (jop, jqt) = _scalar(qs, value)
        got = modring.multiply_poly_scalar(_t(x), op, qt, mc)
        np.testing.assert_array_equal(
            _np(got), _u64(jmodring.multiply_poly_scalar(_pair(x), jop, jqt, jmc)))


@pytest.mark.parametrize("n,tower", CASES)
def test_modulo_poly_coeffs(n, tower):
    qs = _tower(n, tower)
    mc, jmc = _consts(qs)
    rng = np.random.default_rng(7 * n + tower)
    x = rng.integers(0, 1 << 64, (len(qs), n), dtype=np.uint64)
    x[:, 0], x[:, 1] = (1 << 64) - 1, np.array(qs, dtype=np.uint64)
    got = modring.modulo_poly_coeffs(_t(x), mc)
    np.testing.assert_array_equal(_np(got), _u64(jmodring.modulo_poly_coeffs(_pair(x), jmc)))
    np.testing.assert_array_equal(_np(got), x % np.array(qs, dtype=np.uint64)[:, None])


@pytest.mark.parametrize("n,tower", CASES)
def test_negacyclic_shift_poly(n, tower):
    qs = _tower(n, tower)
    mc, jmc = _consts(qs)
    x = _residues(n, qs, seed=3 * n + tower)
    for shift in (0, 1, n - 1):
        got = modring.negacyclic_shift_poly(_t(x), shift, mc)
        np.testing.assert_array_equal(
            _np(got), _u64(jmodring.negacyclic_shift_poly(_pair(x), shift, jmc)), str(shift))
    for shift in (n, 2 * n - 1):
        with pytest.raises(ValueError):
            jmodring.negacyclic_shift_poly(_pair(x), shift, jmc)
        with pytest.raises(ValueError):
            modring.negacyclic_shift_poly(_t(x), shift, mc)


@pytest.mark.parametrize("n,tower", CASES)
def test_negacyclic_multiply_mono(n, tower):
    qs = _tower(n, tower)
    mc, jmc = _consts(qs)
    x = _residues(n, qs, seed=5 * n + tower, batch=(2,))
    (op, qt), (jop, jqt) = _scalar(qs, 12345)
    for exponent in (0, 1, n - 1):
        got = modring.negacyclic_multiply_mono(_t(x), op, qt, exponent, mc)
        np.testing.assert_array_equal(
            _np(got),
            _u64(jmodring.negacyclic_multiply_mono(_pair(x), jop, jqt, exponent, jmc)),
            str(exponent))
    for exponent in (n, 2 * n - 1):
        with pytest.raises(ValueError):
            jmodring.negacyclic_multiply_mono(_pair(x), jop, jqt, exponent, jmc)
        with pytest.raises(ValueError):
            modring.negacyclic_multiply_mono(_t(x), op, qt, exponent, mc)


@pytest.mark.parametrize("n,tower", CASES)
def test_poly_infty_norm(n, tower):
    qs = _tower(n, tower)
    mc, jmc = _consts(qs)
    x = _residues(n, qs, seed=11 * n + tower, batch=(2,))
    # one row whose largest centred value is exactly the threshold (q+1)/2,
    # and one of small values near zero from both sides
    q0 = np.uint64(qs[0])
    x[0, 0, 3:] = np.uint64(5)
    x[0, 0, 3] = (q0 + np.uint64(1)) >> np.uint64(1)
    x[1, 0, :] = [(q0 - np.uint64(k)) if k % 2 else np.uint64(k) for k in range(n)]
    got = modring.poly_infty_norm(_t(x), mc)
    want = _u64(jmodring.poly_infty_norm(_pair(x), jmc))
    assert got.shape == (2, len(qs), 1)
    assert [int(v) for v in got.reshape(-1).tolist()] == [int(v) for v in want.reshape(-1)]


def test_goldens_of_seal_suite():
    """The exact values of SEAL's util tests (tests/test_polyarith.py)."""
    mc = modring.make_mod_consts([15], "cpu")
    assert modring.modulo_poly_coeffs(torch.tensor([[2, 15, 77]]), mc).tolist() == [[2, 0, 2]]
    mc = modring.make_mod_consts([5], "cpu")
    op, qt = modring.shoup_pair([[3]], [[5]], "cpu")
    assert modring.multiply_poly_scalar(torch.tensor([[1, 3, 4]]), op, qt, mc).tolist() == [
        [3, 4, 2]]
    mc = modring.make_mod_consts([10], "cpu")
    a = torch.tensor([[1, 2, 3, 4]])
    assert modring.negacyclic_shift_poly(a, 1, mc).tolist() == [[6, 1, 2, 3]]
    assert modring.negacyclic_shift_poly(a, 3, mc).tolist() == [[8, 7, 6, 1]]
    assert modring.negacyclic_shift_poly(torch.tensor([[1, 2, 3, 0]]), 1, mc).tolist() == [
        [0, 1, 2, 3]]
    op, qt = modring.shoup_pair([[3]], [[10]], "cpu")
    assert modring.negacyclic_multiply_mono(a, op, qt, 2, mc).tolist() == [[1, 8, 3, 6]]
    assert modring.poly_infty_norm(torch.tensor([[0, 1, 2, 3]]), mc).tolist() == [[3]]
    assert modring.poly_infty_norm(torch.tensor([[1, 6, 9]]), mc).tolist() == [[4]]
