"""The port's object API on the CPU against seal_tpu's: the Plaintext
methods on the same hex strings, Modulus.reduce, is_zero and its
comparisons, and EncryptionParameters equality and hash."""

import numpy as np
import pytest
import torch

import seal_tpu
import seal_tpu_torch as st

HEX = ["0", "1", "5", "3x^2 + 1", "7x^9 + 3x^1 + 1", "1x^63", "FFx^10 + 2x^4",
       "100x^3 + 0x^2 + 1x^1"]


def port_plain(text):
    return st.Plaintext.from_hex_string(text, device="cpu")


@pytest.mark.parametrize("text", HEX)
def test_plaintext_methods_match_seal_tpu(text):
    mine, ref = port_plain(text), seal_tpu.Plaintext.from_hex_string(text)
    assert mine.coeff_count == ref.coeff_count
    assert mine.significant_coeff_count() == ref.significant_coeff_count()
    assert mine.nonzero_coeff_count() == ref.nonzero_coeff_count()
    assert mine.is_zero() == ref.is_zero()
    assert mine.to_hex_string() == ref.to_hex_string()
    mine.set_zero()
    ref.set_zero()
    assert mine.is_zero() and ref.is_zero()
    assert mine.coeff_count == ref.coeff_count
    assert (mine.nonzero_coeff_count(), mine.significant_coeff_count()) == \
        (ref.nonzero_coeff_count(), ref.significant_coeff_count())


@pytest.mark.parametrize("a", HEX)
@pytest.mark.parametrize("b", ["0", "1", "3x^2 + 1", "3x^2 + 0x^5 + 1"])
def test_plaintext_equality_matches_seal_tpu(a, b):
    """Zero-padded equality: "3x^2 + 1" equals a longer vector with trailing
    zeros, as in seal_tpu."""
    ref_b = seal_tpu.Plaintext.from_hex_string(b)
    mine_b = port_plain(b)
    if b.endswith("0x^5 + 1"):
        ref_b = seal_tpu.Plaintext(8)
        ref_b.data[0], ref_b.data[2] = 1, 3
        mine_b = st.Plaintext(8, device="cpu")
        mine_b.set_values(ref_b.data)
    want = seal_tpu.Plaintext.from_hex_string(a) == ref_b
    assert (port_plain(a) == mine_b) is want
    assert (mine_b == port_plain(a)) is want


def test_plaintext_constructor_and_set_values():
    p, ref = st.Plaintext(6, device="cpu"), seal_tpu.Plaintext(6)
    assert p.coeff_count == ref.coeff_count == 6
    assert p.is_zero() and p.data.dtype == torch.int64 and p.data.device.type == "cpu"
    values = [5, 0, 2**63 + 7, 0, 1, 0]
    p.set_values(values)
    ref.set_values(values)
    assert np.array_equal(p.to_numpy(), ref.data)
    assert p.significant_coeff_count() == ref.significant_coeff_count() == 5
    assert p.nonzero_coeff_count() == ref.nonzero_coeff_count() == 3
    assert p.data.device.type == "cpu"
    empty = st.Plaintext()
    assert empty.coeff_count == 0 and empty.is_zero() and empty.significant_coeff_count() == 0
    assert empty == st.Plaintext(0, device="cpu") == port_plain("0")
    assert st.Plaintext.__hash__ is None


def test_plaintext_constructor_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        st.Plaintext(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        st.Plaintext().set_values([1, 2])


def test_ntt_form_plaintext_counts_and_equality():
    """An NTT-form plaintext counts over its L·N words (SEAL's
    nonzero_coeff_count, as seal_tpu's), and equality needs the same level,
    scale and words."""
    parms = {}
    for lib in (st, seal_tpu):
        p = lib.EncryptionParameters(lib.SchemeType.CKKS)
        p.set_poly_modulus_degree(64)
        p.set_coeff_modulus(lib.CoeffModulus.create(64, [40, 40, 40]))
        parms[lib] = p
    ctx = st.SEALContext(parms[st], sec_level=st.SecLevelType.NONE, device="cpu")
    ref_ctx = seal_tpu.SEALContext(parms[seal_tpu], sec_level=seal_tpu.SecLevelType.NONE)
    x = np.linspace(-1, 1, 32)
    mine = st.CKKSEncoder(ctx).encode(x, 2.0 ** 20)
    ref = seal_tpu.CKKSEncoder(ref_ctx).encode(x, 2.0 ** 20)
    assert mine.coeff_count == ref.coeff_count == 64
    assert mine.nonzero_coeff_count() == ref.nonzero_coeff_count()
    assert not mine.is_zero() and not ref.is_zero()
    last = int(np.nonzero(mine.to_numpy().reshape(-1))[0][-1])
    assert mine.significant_coeff_count() == last + 1
    same = st.Plaintext(mine.data.clone(), mine.parms_id, mine.scale)
    assert same == mine
    assert st.Plaintext(mine.data, mine.parms_id, 2.0 ** 21) != mine
    other = mine.data.clone()
    other[0, 0] ^= 1
    assert st.Plaintext(other, mine.parms_id, mine.scale) != mine
    assert port_plain("1") != mine
    mine.set_zero()
    ref.set_zero()
    assert mine.is_zero() and ref.is_zero() and mine.nonzero_coeff_count() == 0
    assert tuple(mine.data.shape) == (2, 64) and mine.scale == 2.0 ** 20


VALUES = [0, 2, 3, 257, (1 << 40) - 87, (1 << 60) - 93, (1 << 61) - 1]


@pytest.mark.parametrize("v", VALUES)
def test_modulus_reduce_and_is_zero(v):
    mine, ref = st.Modulus(v), seal_tpu.Modulus(v)
    assert mine.is_zero == ref.is_zero == (v == 0)
    if v:
        for x in (0, 1, v - 1, v, v + 1, 3 * v + 5, (1 << 64) - 1, 12345678901234567890):
            assert mine.reduce(x) == ref.reduce(x) == x % v


@pytest.mark.parametrize("a", VALUES)
@pytest.mark.parametrize("b", VALUES[1:4])
def test_modulus_comparisons(a, b):
    ma, mb = st.Modulus(a), st.Modulus(b)
    ra, rb = seal_tpu.Modulus(a), seal_tpu.Modulus(b)
    for other_m, other_r in ((mb, rb), (b, b)):
        assert (ma == other_m) == (ra == other_r) == (a == b)
        assert (ma != other_m) == (ra != other_r)
        assert (ma < other_m) == (ra < other_r) == (a < b)
        assert (ma <= other_m) == (ra <= other_r) == (a <= b)
        assert (ma > other_m) == (ra > other_r) == (a > b)
        assert (ma >= other_m) == (ra >= other_r) == (a >= b)
    assert (b < ma) == (b < ra) == (b < a)
    assert sorted([st.Modulus(v) for v in reversed(VALUES)]) == [st.Modulus(v) for v in VALUES]
    assert hash(ma) == hash(a)
    with pytest.raises(TypeError):
        ma < "3"


def _parms(lib, scheme, n=64, bits=(40, 40), plain=None, seed=None, alpha=1):
    p = lib.EncryptionParameters(scheme)
    p.set_poly_modulus_degree(n)
    p.set_coeff_modulus(lib.CoeffModulus.create(n, list(bits)))
    if plain is not None:
        p.set_plain_modulus(plain)
    if seed is not None:
        p.set_random_seed(seed)
    p.set_special_modulus_size(alpha)
    return p


CASES = [dict(scheme="CKKS"), dict(scheme="CKKS", bits=(40, 41)),
         dict(scheme="CKKS", n=128), dict(scheme="BFV", plain=257),
         dict(scheme="BFV", plain=17 * 16 + 1 + 256), dict(scheme="BGV", plain=257)]


@pytest.mark.parametrize("i", range(len(CASES)))
@pytest.mark.parametrize("j", range(len(CASES)))
def test_parms_equality_and_hash(i, j):
    def make(lib, case, **extra):
        kw = {k: v for k, v in case.items() if k != "scheme"}
        return _parms(lib, getattr(lib.SchemeType, case["scheme"]), **kw, **extra)

    a, b = make(st, CASES[i]), make(st, CASES[j])
    ra, rb = make(seal_tpu, CASES[i]), make(seal_tpu, CASES[j])
    assert (a == b) == (ra == rb) == (i == j)
    assert (a != b) == (i != j)
    if i == j:
        assert hash(a) == hash(b)
        # the seed, the PRNG type and α are not part of the parameters' identity
        c = make(st, CASES[i], seed=(1, 2, 3, 4, 5, 6, 7, 8), alpha=2)
        assert c == a and hash(c) == hash(a) and len({a, b, c}) == 1
    assert (a == "parms") is False and a.clone() == a
