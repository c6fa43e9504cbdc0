"""The port's BGV scheme on the CPU, bit for bit (tolerance 0).

(a) SEAL's vectors at n = 64 (tests/vectors/bgv_galois_n64.json, the inputs
    of tests/test_bgv_galois_bitexact.py): multiply, relinearize, mod switch,
    add and the chain down to the last level, with their correction factors
    and decryptions. The port makes the keys and both public-key
    ciphertexts from the file's seed; the file's secret key and first
    ciphertext must come out. No seal_tpu Evaluator runs.
(b) The correction-factor balancing of add/sub against seal_tpu's host
    function, and the port's own keys at n = 1024, α = 1 and 2 (the
    pipeline of test_torch_bfv.py), with a sum of ciphertexts whose
    correction factors differ.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import seal_tpu
import seal_tpu_torch as st
from tests.test_torch_bfv import SEED, VG, assert_ct, assert_own_keys_pipeline, port_context, \
    ref


@pytest.fixture(scope="module")
def chain():
    """The port's keys and public-key ciphertexts from the file's seed."""
    ctx = port_context(st.SchemeType.BGV, 64, [40, 40, 40], 257, seed=SEED)
    kg = st.KeyGenerator(ctx)
    np.testing.assert_array_equal(kg.secret_key().to_numpy(), ref(VG, "bgv_secret_key", 3))
    enc = st.Encryptor(ctx, kg.create_public_key())
    c1 = enc.encrypt(st.Plaintext.from_hex_string("5x^3 + 2x^1 + 3", device="cpu"))
    c2 = enc.encrypt(st.Plaintext.from_hex_string("1x^2 + 4", device="cpu"))
    return dict(ctx=ctx, rk=kg.create_relin_keys(), ev=st.Evaluator(ctx),
                dec=st.Decryptor(ctx, kg.secret_key()), c1=c1, c2=c2)


def test_golden_chain(chain):
    ev, dec, rk, c1, c2 = chain["ev"], chain["dec"], chain["rk"], chain["c1"], chain["c2"]
    assert_ct(VG, "bgv_ct1", c1)
    assert_ct(VG, "bgv_add", ev.add(c1, c2))
    mul = ev.multiply(c1, c2)
    assert_ct(VG, "bgv_mul", mul)
    assert mul.correction_factor == VG["bgv_mul_correction"]
    relin = ev.relinearize(mul, rk)
    assert_ct(VG, "bgv_relin", relin)
    ms = ev.mod_switch_to_next(relin)
    assert_ct(VG, "bgv_modswitch", ms)
    assert ms.correction_factor == VG["bgv_modswitch_correction"]
    assert dec.decrypt(ms).to_hex_string() == VG["bgv_modswitch_decrypted"]
    mul2 = ev.multiply(ms, ev.mod_switch_to(c2, ms.parms_id))
    assert_ct(VG, "bgv_mul_level1", mul2)
    assert mul2.correction_factor == VG["bgv_mul_level1_correction"]
    bottom = ev.relinearize(mul2, rk)
    assert_ct(VG, "bgv_chain_bottom", bottom)
    assert bottom.correction_factor == VG["bgv_chain_bottom_correction"]
    assert dec.decrypt(bottom).to_hex_string() == VG["bgv_chain_bottom_decrypted"]


def test_correction_factor_balancing_matches_seal_tpu():
    """Pairs of factors mod 257 and mod 65537; seal_tpu's method reads only
    the two factors and t."""
    rng = np.random.default_rng(5)
    for t, pairs in ((257, [(a, b) for a in range(1, 257, 3) for b in range(1, 257, 5)]),
                     (65537, rng.integers(1, 65537, (200, 2)).tolist())):
        cd = SimpleNamespace(parms=SimpleNamespace(plain_modulus=SimpleNamespace(value=t)))
        for f1, f2 in pairs:
            want = seal_tpu.Evaluator._balance_correction_factors(
                None, SimpleNamespace(correction_factor=f1),
                SimpleNamespace(correction_factor=f2), cd)
            assert st.Evaluator._balance_correction_factors(f1, f2, t) == want, (t, f1, f2)


@pytest.mark.parametrize("alpha", [1, 2])
def test_own_keys_pipeline(alpha):
    """BGV's pipeline, then the sum of a square at the second level
    (factor q_last^-2) and a ciphertext there (factor q_last^-1)."""
    ctx, ev, dec, be, (ct1, ct2, m1, m2) = assert_own_keys_pipeline(st.SchemeType.BGV, alpha)
    t = ctx.first_context_data().parms.plain_modulus.value
    a, b = ev.square(ev.mod_switch_to_next(ct1)), ev.mod_switch_to_next(ct2)
    assert a.correction_factor != b.correction_factor
    for op, want in (("add", m1 * m1 + m2), ("sub", m1 * m1 - m2)):
        out = getattr(ev, op)(a, b)
        np.testing.assert_array_equal(be.decode(dec.decrypt(out)).numpy(), want % t,
                                      err_msg=op)
