"""The port's CKKS encoder, its CRT composition and the CKKS plain ops on
the CPU, bit for bit (tolerance 0; the decoded doubles too).

(a) SEAL's vectors: the encodes of ckks_n64.json (values1/2 at the first
    level, values1 at the second, the real scalar 0.7 and the integer -5),
    the decode of its rescaled product, and the encodes of
    ckks_encode_big_n1024.json whose coefficients pass 2^64 (scales 2^80
    and 2^150).
(b) encode and decode against seal_tpu's host CKKSEncoder at n = 1024:
    complex, real and short vectors, a complex scalar, constant vectors
    whose coefficients are exact halves (std::round rounds them away from
    zero, torch.round would not) and exact negative zeros, and the decode of
    plaintexts of random residues, whose composed values fill the whole of
    Q (the negative branch of SEAL's word-by-word accumulation included).
(c) ops/compose.py against its Python-integer version, at 2-10 primes up
    to 61 bits, with the extreme residues.
(d) The CKKS plain ops and the NTT transforms: add_plain / sub_plain /
    multiply_plain with their checks, and for BFV multiply_plain through
    transform_to_ntt / transform_plain_to_ntt against the coefficient path.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import seal_tpu
import seal_tpu_torch as st
from seal_tpu.dtypes import to_device, to_host
from seal_tpu_torch import interop
from seal_tpu_torch.ops import compose, modring, ntt
from seal_tpu_torch.utils import dwt

VECTORS = pathlib.Path(__file__).parent / "vectors"
V = json.loads((VECTORS / "ckks_n64.json").read_text())
BIG = json.loads((VECTORS / "ckks_encode_big_n1024.json").read_text())
N = 64
SCALE = 2.0 ** 30


def ref(name):
    return np.array(V[name], dtype=np.uint64)


def ckks_context(n, bits, seed=None):
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
    parms.set_random_seed(seed)
    return st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")


def bits_of(x):
    """float64 (or complex128) values as their uint64 words."""
    return np.ascontiguousarray(x).view(np.uint64)


# -- (a) SEAL's vectors ---------------------------------------------------------

@pytest.fixture(scope="module")
def n64():
    ctx = ckks_context(N, [40, 40, 40, 40])
    return ctx, st.CKKSEncoder(ctx)


def test_encodes_match_seal(n64):
    ctx, encoder = n64
    assert encoder.slot_count == N // 2
    for name, vals in (("plain1", "values1"), ("plain2", "values2")):
        p = encoder.encode(np.array(V[vals]), SCALE)
        assert p.scale == SCALE and tuple(p.parms_id) == tuple(ctx.first_parms_id)
        np.testing.assert_array_equal(p.to_numpy().reshape(-1), ref(name), err_msg=name)
    level1 = ctx.first_context_data().next_context_data.parms_id
    np.testing.assert_array_equal(
        encoder.encode(np.array(V["values1"]), SCALE, level1).to_numpy().reshape(-1),
        ref("plain3_level1"))
    np.testing.assert_array_equal(encoder.encode(0.7, SCALE).to_numpy().reshape(-1),
                                  ref("plain_scalar_0p7"))
    p = encoder.encode_int(-5)
    assert p.scale == 1.0
    np.testing.assert_array_equal(p.to_numpy().reshape(-1), ref("plain_int_m5"))


def test_decode_matches_seal(n64):
    ctx, encoder = n64
    level1 = ctx.first_context_data().next_context_data.parms_id
    plain = st.Plaintext(interop.u64_to_tensor(ref("rescale_decrypted").reshape(2, N), ctx),
                         tuple(level1), V["rescale_scale"])
    out = encoder.decode(plain)
    assert out.dtype == torch.float64 and out.device.type == "cpu"
    np.testing.assert_array_equal(bits_of(out.numpy()),
                                  bits_of(np.array(V["rescale_decoded"])))
    assert np.abs(out.numpy() - np.array(V["values1"]) * np.array(V["values2"])).max() < 1e-4


@pytest.mark.parametrize("log_scale", [80, 150])
def test_encodes_past_64_bits_match_seal(log_scale):
    n = BIG["n"]
    encoder = st.CKKSEncoder(ckks_context(n, BIG["bits"]))
    i = np.arange(n >> 1, dtype=np.float64)
    v = ((i % 89) / 89.0 - 0.4) + 1j * ((i % 23) / 23.0)
    np.testing.assert_array_equal(encoder.encode(v, 2.0 ** log_scale).to_numpy().reshape(-1),
                                  np.array(BIG[f"plain_{log_scale}"], dtype=np.uint64))


# -- (b) against seal_tpu's host encoder ---------------------------------------------

N_HOST = 1024
HOST_BITS = [60, 40, 40, 60]


@pytest.fixture(scope="module")
def encoders():
    sp = seal_tpu.EncryptionParameters(seal_tpu.SchemeType.CKKS)
    sp.set_poly_modulus_degree(N_HOST)
    sp.set_coeff_modulus(seal_tpu.CoeffModulus.create(N_HOST, HOST_BITS))
    sctx = seal_tpu.SEALContext(sp, sec_level=seal_tpu.SecLevelType.NONE)
    ctx = ckks_context(N_HOST, HOST_BITS)
    return ctx, st.CKKSEncoder(ctx), sctx, seal_tpu.CKKSEncoder(sctx)


def _cases():
    rng = np.random.default_rng(3)
    half = N_HOST // 2
    return {
        "complex": (rng.uniform(-1, 1, half) + 1j * rng.uniform(-1, 1, half), 2.0 ** 40),
        "real": (rng.normal(0, 100, half), 2.0 ** 30),
        "short": (rng.uniform(-1, 1, 17), 2.0 ** 50),
        "complex_scalar": (0.25 - 3.5j, 2.0 ** 20),
        # constant vectors: the DWT is exact, coefficient 0 is the constant
        # times the scale and the others are zeros
        "halves": (np.full(half, 2.5), 1.0),
        "negative_halves": (np.full(half, -0.5), 5.0),
        "ones": (np.ones(half), 1.0),
        # at scale 1 every coefficient is below 0.06 in magnitude: half of
        # them round to -0.0
        "negative_zeros": (rng.uniform(-1, 1, half), 1.0),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_encode_and_decode_match_seal_tpu(encoders, case):
    ctx, encoder, sctx, sencoder = encoders
    values, scale = _cases()[case]
    got = encoder.encode(values, scale)
    want = sencoder.encode(values, scale)
    np.testing.assert_array_equal(got.to_numpy(), to_host(want.rns_data))
    for complex_out in (False, True):
        np.testing.assert_array_equal(
            bits_of(encoder.decode(got, complex_out=complex_out).numpy()),
            bits_of(sencoder.decode(want, complex_out=complex_out)))


def test_exact_halves_round_away_from_zero(encoders):
    """2.5 encodes to 3 (half to even would give 2), -0.5·5 to -3; a
    negative zero stays -0.0 through the rounding and encodes to 0."""
    ctx, encoder, _, _ = encoders
    q = ctx.first_context_data().key_moduli()
    n = N_HOST
    for values, scale, coeff in ((np.full(n // 2, 2.5), 1.0, 3),
                                 (np.full(n // 2, -0.5), 5.0, -3)):
        plain = encoder.encode(values, scale)
        coeffs = ntt.ntt_inverse(plain.data, ctx.first_context_data().ntt_tables)
        want = np.zeros((len(q), n), dtype=np.int64)
        want[:, 0] = [coeff % p for p in q]
        np.testing.assert_array_equal(coeffs.numpy(), want)
    small = encoder.encode(np.random.default_rng(5).uniform(-1, 1, n // 2), 1.0)
    np.testing.assert_array_equal(small.to_numpy(), np.zeros((len(q), n), dtype=np.uint64))
    x = torch.tensor([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, -0.0, 0.0, -1e-17, 0.49999999999999994],
                     dtype=torch.float64)
    got = dwt.round_half_away(x).numpy()
    np.testing.assert_array_equal(bits_of(got), bits_of(np.array(
        [1.0, -1.0, 2.0, -2.0, 3.0, -3.0, -0.0, 0.0, -0.0, 0.0])))
    assert [dwt.round_half_away_scalar(v) for v in (2.5, -2.5, -0.0, 0.4)] == [3, -3, 0, 0]


def test_decode_of_random_residues_matches_seal_tpu(encoders):
    """Plaintexts of uniform residues: composed values anywhere in [0, Q),
    half of them at or above (Q + 1)/2."""
    ctx, encoder, sctx, sencoder = encoders
    rng = np.random.default_rng(11)
    for level in range(2):
        cd, scd = ctx.first_context_data(), sctx.first_context_data()
        for _ in range(level):
            cd, scd = cd.next_context_data, scd.next_context_data
        rows = np.stack([rng.integers(0, q, N_HOST, dtype=np.uint64) for q in cd.key_moduli()])
        rows[:, :2] = np.array([[0, q - 1] for q in cd.key_moduli()], dtype=np.uint64)
        plain = st.Plaintext(interop.u64_to_tensor(rows, ctx), tuple(cd.parms_id), 2.0 ** 40)
        sp = seal_tpu.Plaintext()
        sp.rns_data = to_device(rows)
        sp.parms_id, sp.scale = tuple(scd.parms_id), 2.0 ** 40
        np.testing.assert_array_equal(bits_of(encoder.decode(plain, complex_out=True).numpy()),
                                      bits_of(sencoder.decode(sp, complex_out=True)))


def test_encode_errors(encoders):
    ctx, encoder, _, _ = encoders
    with pytest.raises(ValueError, match="values_size is too large"):
        encoder.encode(np.zeros(N_HOST // 2 + 1), 2.0 ** 20)
    with pytest.raises(ValueError, match="scale out of bounds"):
        encoder.encode([1.0], 2.0 ** 200)
    with pytest.raises(ValueError, match="encoded values are too large"):
        encoder.encode([2.0 ** 100], 2.0 ** 90)
    with pytest.raises(ValueError, match="encoded value is too large"):
        encoder.encode_int(1 << 200)
    with pytest.raises(ValueError, match="not valid for CKKS decoding"):
        encoder.decode(st.Plaintext(torch.zeros(N_HOST, dtype=torch.int64)))
    assert st.CKKSEncoder.encode_device is st.CKKSEncoder.encode
    assert st.CKKSEncoder.decode_device is st.CKKSEncoder.decode


# -- (c) the composition ------------------------------------------------------------

@pytest.mark.parametrize("bits", [[30, 30], [60] * 3, [50, 60, 60, 45], [40] * 10])
def test_compose_matches_python_ints(bits):
    n = 256
    moduli = [m.value for m in st.CoeffModulus.create(n, bits)]
    rng = np.random.default_rng(len(bits))
    rows = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in moduli])
    rows[:, 0] = 0
    rows[:, 1] = [q - 1 for q in moduli]
    rows[:, 2] = [1] * len(moduli)
    c = compose.make_compose_consts(moduli, "cpu")
    limbs = compose.compose(torch.from_numpy(rows.view(np.int64)), c).numpy()
    assert limbs.min() >= 0 and limbs.max() < 1 << 32
    got = [sum(int(w) << (32 * k) for k, w in enumerate(col)) for col in limbs.T]
    assert got == compose.compose_plain(rows.tolist(), moduli)
    Q = int(np.prod([int(q) for q in moduli], dtype=object))
    bit_len = compose.bit_length(torch.from_numpy(limbs)).tolist()
    assert bit_len == [v.bit_length() for v in got] and got[1] == Q - 1


def test_compose_with_61_bit_primes():
    """BFV's auxiliary primes have 61 bits: y·(Q/q) limbs still sum exactly."""
    from seal_tpu_torch.utils import numth

    n = 64
    moduli = numth.get_primes(2 * n, 61, 5)
    rng = np.random.default_rng(61)
    rows = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in moduli])
    rows[:, 0] = [q - 1 for q in moduli]
    limbs = compose.compose(torch.from_numpy(rows.view(np.int64)),
                            compose.make_compose_consts(moduli, "cpu")).numpy()
    got = [sum(int(w) << (32 * k) for k, w in enumerate(col)) for col in limbs.T]
    assert got == compose.compose_plain(rows.tolist(), moduli)


# -- (d) the CKKS plain ops and the NTT transforms ---------------------------------------

def test_ckks_plain_ops_check_level_and_scale(n64):
    ctx, encoder = n64
    parms = ctx.key_context_data().parms
    cd = ctx.first_context_data()
    zero = st.Ciphertext(torch.zeros((2, 3, N), dtype=torch.int64), tuple(cd.parms_id), True,
                         SCALE)
    ev = st.Evaluator(ctx)
    p = encoder.encode([1.0, 2.0], SCALE)
    np.testing.assert_array_equal(ev.add_plain(zero, p).data[0].numpy(), p.data.numpy())
    np.testing.assert_array_equal(ev.sub_plain(zero, p).data[0].numpy(),
                                  modring.negate_poly(p.data, cd.mod_consts).numpy())
    prod = ev.multiply_plain(ev.add_plain(zero, p), encoder.encode([3.0], SCALE))
    assert prod.scale == SCALE * SCALE
    with pytest.raises(ValueError, match="scale mismatch"):
        ev.add_plain(zero, encoder.encode([1.0], 2.0 ** 20))
    with pytest.raises(ValueError, match="parameter mismatch"):
        ev.add_plain(zero, encoder.encode([1.0], SCALE, cd.next_context_data.parms_id))
    with pytest.raises(ValueError, match="scale out of bounds"):
        ev.multiply_plain(zero, encoder.encode([1.0], 2.0 ** 100))
    assert parms.scheme == st.SchemeType.CKKS


def test_bfv_multiply_plain_in_ntt_form_equals_coefficient_form():
    parms = st.EncryptionParameters(st.SchemeType.BFV)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(st.CoeffModulus.create(N, [40, 40, 40]))
    parms.set_plain_modulus(257)
    parms.set_random_seed((4,) * 8)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    kg = st.KeyGenerator(ctx)
    ct = st.Encryptor(ctx, kg.create_public_key()).encrypt(
        st.Plaintext.from_hex_string("7x^5 + 3", device="cpu"))
    plain = st.Plaintext.from_hex_string("100x^3 + 2x^1 + 1", device="cpu")
    ev = st.Evaluator(ctx)
    want = ev.multiply_plain(ct, plain)
    ct_ntt = ev.transform_to_ntt(ct)
    assert ct_ntt.is_ntt_form
    plain_ntt = ev.transform_plain_to_ntt(plain, ct.parms_id)
    got = ev.transform_from_ntt(ev.multiply_plain(ct_ntt, plain_ntt))
    assert not got.is_ntt_form
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    np.testing.assert_array_equal(ev.transform_from_ntt(ct_ntt).to_numpy(), ct.to_numpy())
    # (7x^5 + 3)(256x^3 + 2x + 1) mod 257
    assert st.Decryptor(ctx, kg.secret_key()).decrypt(got).to_hex_string() == \
        "FAx^8 + Ex^6 + 7x^5 + FEx^3 + 6x^1 + 3"
    with pytest.raises(ValueError, match="NTT form mismatch"):
        ev.multiply_plain(ct_ntt, plain)
    with pytest.raises(ValueError, match="already in NTT form"):
        ev.transform_to_ntt(ct_ntt)
    with pytest.raises(ValueError, match="not in NTT form"):
        ev.transform_from_ntt(ct)


# -- (c) encode_device / decode_device ---------------------------------------------

def test_device_names_are_the_float64_encoder():
    """seal_tpu's encode_device / decode_device exist because the TPU has no
    float64 (a float32-pair FFT, ops/cfft.py); the port's are its encode /
    decode, which compute SEAL's bits in float64 on the context's device."""
    assert st.CKKSEncoder.encode_device is st.CKKSEncoder.encode
    assert st.CKKSEncoder.decode_device is st.CKKSEncoder.decode


def test_encode_device_is_seal_tpu_host_encode(encoders):
    """At n = 1024 the port's encode_device is seal_tpu's host encode bit
    for bit, and its decode_device seal_tpu's host decode."""
    ctx, encoder, sctx, sencoder = encoders
    rng = np.random.default_rng(1)
    half = N_HOST // 2
    vals = rng.uniform(-10, 10, half) + 1j * rng.uniform(-10, 10, half)
    got = encoder.encode_device(vals, 2.0 ** 30)
    want = sencoder.encode(vals, 2.0 ** 30)
    np.testing.assert_array_equal(got.to_numpy(), to_host(want.rns_data))
    np.testing.assert_array_equal(bits_of(encoder.decode_device(got, complex_out=True).numpy()),
                                  bits_of(sencoder.decode(want, complex_out=True)))


def test_encode_device_within_seal_tpus_device_tolerances():
    """tests/test_ckks_device_encoder.py's context (n = 128, bits [40, 30,
    30, 40]) and inputs: the port's encode_device -> decode within 1e-5 of
    the values, as seal_tpu's encode_device is held, and within 1e-5 of
    seal_tpu's encode_device -> decode; the port's decode_device of a host
    encode within 1e-5 of the values and 1e-7 of seal_tpu's decode_device."""
    n, bits = 128, [40, 30, 30, 40]
    sp = seal_tpu.EncryptionParameters(seal_tpu.SchemeType.CKKS)
    sp.set_poly_modulus_degree(n)
    sp.set_coeff_modulus(seal_tpu.CoeffModulus.create(n, bits))
    sencoder = seal_tpu.CKKSEncoder(seal_tpu.SEALContext(sp, sec_level=seal_tpu.SecLevelType.NONE))
    encoder = st.CKKSEncoder(ckks_context(n, bits))
    rng = np.random.default_rng(1)
    vals = rng.uniform(-10, 10, n // 2) + 1j * rng.uniform(-10, 10, n // 2)
    out = encoder.decode(encoder.encode_device(vals, 2.0 ** 30), complex_out=True).numpy()
    s_out = np.asarray(sencoder.decode(sencoder.encode_device(vals, 2.0 ** 30), complex_out=True))
    assert np.max(np.abs(out - vals)) < 1e-5
    assert np.max(np.abs(s_out - vals)) < 1e-5
    assert np.max(np.abs(out - s_out)) < 1e-5
    real = np.linspace(-3, 3, n // 2)
    decoded = encoder.decode_device(encoder.encode(real, 2.0 ** 30)).numpy()
    s_decoded = np.asarray(sencoder.decode_device(sencoder.encode(real, 2.0 ** 30)))
    assert np.max(np.abs(decoded - real)) < 1e-5
    assert np.max(np.abs(decoded - s_decoded)) < 1e-7
