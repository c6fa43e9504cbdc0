"""The port's BFV scheme on the CPU, bit for bit (tolerance 0).

(a) SEAL's own vectors at n = 64 (tests/vectors/bfv_n64.json, the inputs of
    tests/test_bfv_bitexact.py): the file's secret key, relinearization key
    and ciphertexts are carried in, and the port's add, negate, multiply,
    relinearize, mod switch, add_plain, multiply_plain, decryptions and
    BatchEncoder must give the file's words and strings. The rotation vectors
    of bgv_galois_n64.json (bfv_rot3, bfv_galois9) need Galois keys and a
    ciphertext that the file lacks: the port makes them from the file's
    seed, as tests/test_bgv_galois_bitexact.py does with seal_tpu. No
    seal_tpu Evaluator runs.
(c) The port's own keys at n = 1024, α = 1 and 2: encode, encrypt (the
    first input with the public key, the second with the secret key),
    multiply, relinearize, mod switch, rotate_rows / rotate_columns, the
    plain ops and square, decrypt and decode to the exact slotwise result.
    test_torch_bgv.py runs the same pipeline for BGV.
"""

import json
import pathlib

import numpy as np
import pytest

import seal_tpu
import seal_tpu_torch as st
from seal_tpu_torch import interop

VECTORS = pathlib.Path(__file__).parent / "vectors"
V = json.loads((VECTORS / "bfv_n64.json").read_text())
VG = json.loads((VECTORS / "bgv_galois_n64.json").read_text())
SEED = (1, 2, 3, 4, 5, 6, 7, 8)


def port_context(scheme, n, bits, t, alpha=1, seed=None):
    parms = st.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
    parms.set_plain_modulus(t)
    parms.set_special_modulus_size(alpha)
    parms.set_random_seed(seed)
    return st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")


def seal_tpu_context(scheme):
    """seal_tpu's context of the n = 64 vectors, with SEAL's seeded PRNG."""
    parms = seal_tpu.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(seal_tpu.CoeffModulus.create(64, [40, 40, 40]))
    parms.set_plain_modulus(257)
    parms.set_random_seed(SEED)
    return seal_tpu.SEALContext(parms, sec_level=seal_tpu.SecLevelType.NONE)


def ref(vectors, name, L):
    return np.array(vectors[name], dtype=np.uint64).reshape(L, 64)


def assert_ct(vectors, name, ct):
    arr = ct.to_numpy()
    assert arr.shape[0] == ct.size
    for j in range(ct.size):
        np.testing.assert_array_equal(arr[j].reshape(-1),
                                      np.array(vectors[f"{name}_c{j}"], dtype=np.uint64),
                                      err_msg=f"{name}_c{j}")


# -- (a) SEAL's vectors ----------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    ctx = port_context(st.SchemeType.BFV, 64, [40, 40, 40], 257)
    sk = interop.secret_key_from_numpy(ctx, ref(V, "secret_key", 3))
    rk = interop.relin_keys_from_numpy(ctx, [np.stack([
        np.stack([ref(V, f"relin0_{i}_c{c}", 3) for c in range(2)]) for i in range(2)])])

    def ct(name):
        return interop.ciphertext_from_numpy(
            ctx, np.stack([ref(V, f"{name}_c{j}", 2) for j in range(2)]),
            ctx.first_parms_id, 1.0, is_ntt_form=False)

    return dict(ctx=ctx, rk=rk, ev=st.Evaluator(ctx), dec=st.Decryptor(ctx, sk),
                ct1=ct("ct1"), ct2=ct("ct2"),
                p1=st.Plaintext.from_hex_string("5x^3 + 2x^1 + 3", device="cpu"),
                p2=st.Plaintext.from_hex_string("1x^63 + 4x^2 + 1", device="cpu"))


def test_parameters_match_seal_tpu():
    """parms_id of every level, SEAL's default moduli (the historical
    single-prime entries too), batching t and the context's BFV constants."""
    ctx = port_context(st.SchemeType.BFV, 64, [40, 40, 40], 257)
    sctx = seal_tpu_context(seal_tpu.SchemeType.BFV)
    cd, scd = ctx.key_context_data(), sctx.key_context_data()
    while cd is not None:
        assert tuple(cd.parms_id) == tuple(scd.parms_id)
        for name in ("coeff_div_plain_modulus", "coeff_modulus_mod_plain_modulus",
                     "upper_half_increment", "plain_upper_half_threshold",
                     "plain_upper_half_increment"):
            assert getattr(cd, name) == getattr(scd, name), name
        assert (cd.qualifiers.using_batching, cd.qualifiers.using_fast_plain_lift) == (
            scd.qualifiers.using_batching, scd.qualifiers.using_fast_plain_lift)
        cd, scd = cd.next_context_data, scd.next_context_data
    assert scd is None
    for n in (1024, 2048, 4096, 8192, 16384, 32768):
        for sec in (st.SecLevelType.TC128, st.SecLevelType.TC192, st.SecLevelType.TC256):
            assert [m.value for m in st.CoeffModulus.bfv_default(n, sec)] == [
                m.value for m in seal_tpu.CoeffModulus.bfv_default(
                    n, seal_tpu.SecLevelType(int(sec)))], (n, sec)
    assert st.PlainModulus.batching(16384, 20).value == \
        seal_tpu.PlainModulus.batching(16384, 20).value
    assert [m.value for m in st.CoeffModulus.create(64, [30, 40], plain_modulus=257)] == [
        m.value for m in seal_tpu.CoeffModulus.create(64, [30, 40], plain_modulus=257)]


@pytest.mark.parametrize("op", ["add", "neg", "add_plain", "mul_plain"])
def test_golden_linear_and_plain_ops(golden, op):
    g = golden
    ev = g["ev"]
    out = {"add": lambda: ev.add(g["ct1"], g["ct2"]), "neg": lambda: ev.negate(g["ct1"]),
           "add_plain": lambda: ev.add_plain(g["ct1"], g["p2"]),
           "mul_plain": lambda: ev.multiply_plain(g["ct1"], g["p2"])}[op]()
    assert_ct(V, f"ct_{op}", out)


def test_golden_multiply_relinearize_modswitch_decrypt(golden):
    g = golden
    ev, dec = g["ev"], g["dec"]
    mul = ev.multiply(g["ct1"], g["ct2"])
    assert_ct(V, "ct_mul", mul)
    assert dec.decrypt(mul).to_hex_string() == V["mul_decrypted"]
    relin = ev.relinearize(mul, g["rk"])
    assert_ct(V, "ct_relin", relin)
    assert dec.decrypt(relin).to_hex_string() == V["relin_decrypted"]
    ms = ev.mod_switch_to_next(relin)
    assert_ct(V, "ct_modswitch", ms)
    assert tuple(ms.parms_id) == tuple(g["ctx"].last_parms_id)
    assert dec.decrypt(ms).to_hex_string() == V["modswitch_decrypted"]
    assert dec.decrypt(g["ct1"]).to_hex_string() == "5x^3 + 2x^1 + 3"


def test_golden_square_and_batch_encode(golden):
    """square gives multiply(a, a)'s bits; BatchEncoder gives the file's
    coefficients and decodes them back."""
    g = golden
    ev = g["ev"]
    sq = ev.square(g["ct1"])
    np.testing.assert_array_equal(sq.to_numpy(), ev.multiply(g["ct1"], g["ct1"]).to_numpy())
    assert g["dec"].decrypt(ev.relinearize(sq, g["rk"])).to_hex_string() == \
        "19x^6 + 14x^4 + 1Ex^3 + 4x^2 + Cx^1 + 9"
    be = st.BatchEncoder(g["ctx"])
    vals = [(i * 7 + 1) % 257 for i in range(64)]
    p = be.encode(vals)
    np.testing.assert_array_equal(p.to_numpy(), np.array(V["batch_encoded"], dtype=np.uint64))
    assert be.decode(p).tolist() == vals
    assert be.decode(be.encode([-1, 5]), signed=True).tolist()[:3] == [-1, 5, 0]


def test_golden_rotations():
    """bfv_rot3 (rotate_rows by 3: Galois element 27) and bfv_galois9, on
    the port's Galois keys and public-key ciphertext from the file's seed."""
    ctx = port_context(st.SchemeType.BFV, 64, [40, 40, 40], 257, seed=SEED)
    kg = st.KeyGenerator(ctx)
    pk = kg.create_public_key()
    keys = kg.create_galois_keys([3, 9, 27, 127])
    ct = st.Encryptor(ctx, pk).encrypt(st.BatchEncoder(ctx).encode(list(range(64))))
    ev = st.Evaluator(ctx)
    assert_ct(VG, "bfv_rot3", ev.rotate_rows(ct, 3, keys))
    assert_ct(VG, "bfv_galois9", ev.apply_galois(ct, 9, keys))
    with pytest.raises(ValueError, match="unsupported scheme"):
        ev.rotate_vector(ct, 3, keys)


# -- (c) the port's own keys -------------------------------------------------------

N_OWN = 1024
OWN_BITS = {1: [50] * 4 + [60], 2: [50] * 4 + [55] * 2}


def assert_own_keys_pipeline(scheme, alpha):
    """encode -> encrypt -> multiply -> relinearize -> mod switch ->
    rotate_rows(1) / rotate_columns -> decrypt -> decode, plus square,
    multiply_plain, add_plain, sub and negate: every decode equals the exact
    slotwise result mod t."""
    t = st.PlainModulus.batching(N_OWN, 20).value
    ctx = port_context(scheme, N_OWN, OWN_BITS[alpha], t, alpha, seed=(alpha, int(scheme)) * 4)
    kg = st.KeyGenerator(ctx)
    rk, gk = kg.create_relin_keys(), kg.create_galois_keys(steps=[1, 0])
    enc = st.Encryptor(ctx, kg.create_public_key(), kg.secret_key())
    dec, ev = st.Decryptor(ctx, kg.secret_key()), st.Evaluator(ctx)
    be = st.BatchEncoder(ctx)
    rng = np.random.default_rng(alpha)
    m1, m2 = (rng.integers(0, t, N_OWN, dtype=np.int64) for _ in range(2))
    ct1, ct2 = enc.encrypt(be.encode(m1)), enc.encrypt_symmetric(be.encode(m2))

    def decoded(ct):
        return be.decode(dec.decrypt(ct)).numpy()

    prod = m1 * m2 % t
    mul = ev.multiply(ct1, ct2)
    ms = ev.mod_switch_to_next(ev.relinearize(mul, rk))
    assert ms.size == 2 and ms.coeff_modulus_size == 3
    half = N_OWN // 2
    rows = prod.reshape(2, half)
    for name, ct, want in (
            ("multiply", mul, prod), ("mod_switch_to_next", ms, prod),
            ("rotate_rows", ev.rotate_rows(ms, 1, gk), np.roll(rows, -1, axis=1).reshape(-1)),
            ("rotate_columns", ev.rotate_columns(ms, gk), rows[::-1].reshape(-1)),
            ("square", ev.square(ct1), m1 * m1 % t),
            ("multiply_plain", ev.multiply_plain(ct1, be.encode(m2)), prod),
            ("add_plain", ev.add_plain(ct1, be.encode(m2)), (m1 + m2) % t),
            ("sub", ev.sub(ct1, ct2), (m1 - m2) % t),
            ("negate", ev.negate(ct1), -m1 % t)):
        np.testing.assert_array_equal(decoded(ct), want, err_msg=name)
    return ctx, ev, dec, be, (ct1, ct2, m1, m2)


@pytest.mark.parametrize("alpha", [1, 2])
def test_own_keys_pipeline(alpha):
    assert_own_keys_pipeline(st.SchemeType.BFV, alpha)
