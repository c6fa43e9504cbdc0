"""The port's keys and encryptions from a random seed, and the invariant
noise budget, on the CPU, bit for bit (tolerance 0; the decoded doubles
against the exact product within 1e-4).

(a) SEAL's CKKS run of tests/vectors/ckks_n64.json from
    parms.set_random_seed((1, ..., 8)) alone, no key loaded from the file:
    the secret, public and relinearization keys, the encodes, the public-
    and secret-key ciphertexts, the encryption at the second level,
    add_plain and multiply_plain, the product through multiply ->
    relinearize -> rescale, its decryption and its decoded doubles.
(b) Keys against seal_tpu's seeded host KeyGenerator at n = 1024: secret,
    public, relinearization and Galois keys, for CKKS, BFV and BGV, α = 1
    and 2, blake2xb and shake256.
(c) Public-key encryption where its mod switch is not covered by SEAL's
    vectors (BFV at α = 2, whose first step divides by both special primes
    in coefficient form; CKKS at α = 2 below the first level), and BFV
    secret-key encryption with save_seed (c1 then is the sampled
    coefficient form), against seal_tpu. BFV and BGV public-key encryption
    at α = 1 and 2 also runs in the own-keys pipelines of
    test_torch_bfv.py and test_torch_bgv.py.
(d) invariant_noise_budget: the whole of noise_budget_chain.json (SEAL's
    budgets along a BFV chain at n = 8192, mod switches included), and a
    short BFV and a short BGV chain at n = 1024 run by the port, each
    ciphertext carried into seal_tpu and held against its Decryptor.
(e) The API: KeyGenerator(context, secret_key), the seeds kept with
    save_seed, fresh seeds without a random seed, encrypt_zero, and the
    errors of a missing key.
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
from seal_tpu_torch.ops import ntt

VECTORS = pathlib.Path(__file__).parent / "vectors"
V = json.loads((VECTORS / "ckks_n64.json").read_text())
SEED = (1, 2, 3, 4, 5, 6, 7, 8)


def ref(name):
    return np.array(V[name], dtype=np.uint64)


def assert_ct(name, ct):
    arr = ct.to_numpy()
    assert arr.shape[0] == ct.size
    for j in range(ct.size):
        np.testing.assert_array_equal(arr[j].reshape(-1), ref(f"{name}_c{j}"),
                                      err_msg=f"{name}_c{j}")


def u64(t):
    return t.numpy().view(np.uint64)


# -- (a) SEAL's CKKS run from the seed ------------------------------------------

@pytest.fixture(scope="module")
def seeded():
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(st.CoeffModulus.create(64, V["coeff_modulus_bits"]))
    parms.set_random_seed(SEED)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    kg = st.KeyGenerator(ctx)
    pk, rk = kg.create_public_key(), kg.create_relin_keys()
    encoder = st.CKKSEncoder(ctx)
    scale = 2.0 ** V["scale_log2"]
    p1 = encoder.encode(np.array(V["values1"]), scale)
    p2 = encoder.encode(np.array(V["values2"]), scale)
    enc = st.Encryptor(ctx, pk, kg.secret_key())
    return dict(ctx=ctx, kg=kg, pk=pk, rk=rk, encoder=encoder, enc=enc, scale=scale,
                p1=p1, p2=p2, ct1=enc.encrypt(p1), ct2=enc.encrypt(p2), ev=st.Evaluator(ctx),
                dec=st.Decryptor(ctx, kg.secret_key()))


def test_seeded_keys(seeded):
    np.testing.assert_array_equal(seeded["kg"].secret_key().to_numpy().reshape(-1),
                                  ref("secret_key"))
    pk = seeded["pk"].to_numpy()
    np.testing.assert_array_equal(pk[0].reshape(-1), ref("public_key_c0"))
    np.testing.assert_array_equal(pk[1].reshape(-1), ref("public_key_c1"))
    key = u64(seeded["rk"].keys[0])
    assert key.shape == (3, 2, 4, 64)
    for i in range(3):
        for c in range(2):
            np.testing.assert_array_equal(key[i, c].reshape(-1), ref(f"relin_key_{i}_c{c}"))


def test_seeded_encodes_and_encryptions(seeded):
    np.testing.assert_array_equal(seeded["p1"].to_numpy().reshape(-1), ref("plain1"))
    np.testing.assert_array_equal(seeded["p2"].to_numpy().reshape(-1), ref("plain2"))
    assert_ct("ct1", seeded["ct1"])
    assert_ct("ct2", seeded["ct2"])
    assert seeded["ct1"].scale == seeded["scale"]
    assert_ct("ct1_sym", seeded["enc"].encrypt_symmetric(seeded["p1"]))
    ctx = seeded["ctx"]
    level1 = ctx.first_context_data().next_context_data.parms_id
    p3 = seeded["encoder"].encode(np.array(V["values1"]), seeded["scale"], level1)
    np.testing.assert_array_equal(p3.to_numpy().reshape(-1), ref("plain3_level1"))
    ct3 = seeded["enc"].encrypt(p3)
    assert tuple(ct3.parms_id) == tuple(level1)
    assert_ct("ct3_level1", ct3)


def test_seeded_plain_ops(seeded):
    ev = seeded["ev"]
    assert_ct("add_plain", ev.add_plain(seeded["ct1"], seeded["p2"]))
    assert_ct("mul_plain", ev.multiply_plain(seeded["ct1"], seeded["p2"]))


def test_seeded_round_trip(seeded):
    ev, dec, encoder = seeded["ev"], seeded["dec"], seeded["encoder"]
    mul = ev.multiply(seeded["ct1"], seeded["ct2"])
    assert_ct("mul", mul)
    relin = ev.relinearize(mul, seeded["rk"])
    assert_ct("relin", relin)
    out = ev.rescale_to_next(relin)
    assert_ct("rescale", out)
    assert out.scale == V["rescale_scale"]
    plain = dec.decrypt(out)
    np.testing.assert_array_equal(plain.to_numpy().reshape(-1), ref("rescale_decrypted"))
    decoded = encoder.decode(plain).numpy()
    np.testing.assert_array_equal(decoded.view(np.uint64),
                                  np.array(V["rescale_decoded"]).view(np.uint64))
    exact = np.array(V["values1"]) * np.array(V["values2"])
    assert np.abs(decoded - exact).max() <= 1e-4


# -- (d) the noise budget along SEAL's chain (before any of seal_tpu's jit
#    compiles below, whose thread pools slow the CPU down for a while) ------

def test_noise_budget_chain_matches_seal():
    """tests/vectors/noise_budget_chain.json: SEAL's budget after every op
    of a BFV chain at n = 8192 from seed (1, ..., 8). It runs on one
    intra-op thread: beside the suite's other worker processes, a thread
    per core waits at every op's barrier for threads that are not
    running."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _noise_budget_chain()
    finally:
        torch.set_num_threads(threads)


def _noise_budget_chain():
    steps = json.loads((VECTORS / "noise_budget_chain.json").read_text())["steps"]
    parms = st.EncryptionParameters(st.SchemeType.BFV)
    parms.set_poly_modulus_degree(8192)
    parms.set_coeff_modulus(st.CoeffModulus.create(8192, [43, 43, 43, 43, 46]))
    parms.set_plain_modulus(st.PlainModulus.batching(8192, 20))
    parms.set_random_seed(SEED)
    ctx = st.SEALContext(parms, device="cpu")
    kg = st.KeyGenerator(ctx)
    rk, ev, be = kg.create_relin_keys(), st.Evaluator(ctx), st.BatchEncoder(ctx)
    dec = st.Decryptor(ctx, kg.secret_key())
    ct = st.Encryptor(ctx, kg.create_public_key()).encrypt(
        be.encode(np.arange(8192, dtype=np.int64) % 7))
    got = [["fresh", dec.invariant_noise_budget(ct)]]
    while True:
        ct = ev.multiply(ct, ct)
        got.append(["multiply", dec.invariant_noise_budget(ct)])
        ct = ev.relinearize(ct, rk)
        got.append(["relinearize", dec.invariant_noise_budget(ct)])
        if ctx.get_context_data(ct.parms_id).next_context_data is None:
            break
        ct = ev.mod_switch_to_next(ct)
        got.append(["mod_switch", dec.invariant_noise_budget(ct)])
        if got[-1][1] <= 0:
            break
    assert got == steps


# -- (b) keys against seal_tpu -----------------------------------------------------------

N_HOST = 1024


def _contexts(scheme_name, alpha, seed, bits=None, prng=None):
    """(the port's context, seal_tpu's) from the same parameters and seed."""
    out = []
    for lib, device in ((st, {"device": "cpu"}), (seal_tpu, {})):
        scheme = lib.SchemeType[scheme_name]
        parms = lib.EncryptionParameters(scheme)
        parms.set_poly_modulus_degree(N_HOST)
        parms.set_coeff_modulus(lib.CoeffModulus.create(
            N_HOST, bits or [50] * 3 + [60 - 5 * (alpha - 1)] * alpha))
        if scheme_name != "CKKS":
            parms.set_plain_modulus(lib.PlainModulus.batching(N_HOST, 20))
        parms.set_special_modulus_size(alpha)
        parms.set_random_seed(seed)
        if prng is not None:
            parms.set_prng_type(int(prng))
        out.append(lib.SEALContext(parms, sec_level=lib.SecLevelType.NONE, **device))
    assert tuple(out[0].key_parms_id) == tuple(out[1].key_parms_id)
    return out


@pytest.mark.parametrize("scheme,alpha,prng", [
    ("CKKS", 1, "BLAKE2XB"), ("CKKS", 2, "BLAKE2XB"), ("CKKS", 1, "SHAKE256"),
    ("BFV", 1, "BLAKE2XB"), ("BFV", 2, "BLAKE2XB"), ("BGV", 1, "BLAKE2XB")])
def test_keys_match_seal_tpu(scheme, alpha, prng):
    ctx, sctx = _contexts(scheme, alpha, (5, alpha, 0, 0, 0, 0, 0, 1), prng=st.PrngType[prng])
    kg, skg = st.KeyGenerator(ctx), seal_tpu.KeyGenerator(sctx)
    np.testing.assert_array_equal(kg.secret_key().to_numpy(), skg.secret_key().to_numpy())
    np.testing.assert_array_equal(kg.create_public_key().to_numpy(),
                                  skg.create_public_key().data.to_numpy())
    np.testing.assert_array_equal(u64(kg.create_relin_keys().keys[0]),
                                  to_host(skg.create_relin_keys().keys[0]))
    gk, sgk = kg.create_galois_keys(steps=[1, 0]), skg.create_galois_keys(steps=[1, 0])
    assert len(gk.keys) == len(sgk.keys) == N_HOST
    for k, sk in zip(gk.keys, sgk.keys):
        assert (k is None) == (sk is None)
        if k is not None:
            np.testing.assert_array_equal(u64(k), to_host(sk))


# -- (c) encryptions against seal_tpu -------------------------------------------------------

@pytest.mark.parametrize("scheme,alpha,level", [("BFV", 2, 0), ("CKKS", 2, 1)])
def test_public_key_encryption_matches_seal_tpu(scheme, alpha, level):
    ctx, sctx = _contexts(scheme, alpha, (6, alpha) + (0,) * 6)
    kg, skg = st.KeyGenerator(ctx), seal_tpu.KeyGenerator(sctx)
    enc = st.Encryptor(ctx, kg.create_public_key())
    senc = seal_tpu.Encryptor(sctx, skg.create_public_key())
    if scheme == "CKKS":
        values = np.linspace(-1, 1, N_HOST // 2)
        parms_id = ctx.first_context_data().next_context_data.parms_id
        ct = enc.encrypt(st.CKKSEncoder(ctx).encode(values, 2.0 ** 30, parms_id))
        sct = senc.encrypt(seal_tpu.CKKSEncoder(sctx).encode(values, 2.0 ** 30, parms_id))
    else:
        values = list(range(100))
        ct = enc.encrypt(st.BatchEncoder(ctx).encode(values))
        sct = senc.encrypt(seal_tpu.BatchEncoder(sctx).encode(values))
    np.testing.assert_array_equal(ct.to_numpy(), sct.to_numpy())
    assert tuple(ct.parms_id) == tuple(sct.parms_id) and ct.scale == sct.scale
    assert ct.is_ntt_form == sct.is_ntt_form


def test_symmetric_encryption_with_save_seed_matches_seal_tpu():
    ctx, sctx = _contexts("BFV", 1, (7,) * 8)
    kg, skg = st.KeyGenerator(ctx), seal_tpu.KeyGenerator(sctx)
    plain, splain = (lib.Plaintext.from_hex_string("3x^2 + 1", **kw)
                     for lib, kw in ((st, {"device": "cpu"}), (seal_tpu, {})))
    for save_seed in (False, True):
        ct = st.Encryptor(ctx, kg.secret_key()).encrypt_symmetric(plain, save_seed=save_seed)
        sct = seal_tpu.Encryptor(sctx, skg.secret_key()).encrypt_symmetric(
            splain, save_seed=save_seed)
        np.testing.assert_array_equal(ct.to_numpy(), sct.to_numpy())
        assert ct.seed_info == (sct.seed_info if save_seed else None)
        assert st.Decryptor(ctx, kg.secret_key()).decrypt(ct).to_hex_string() == "3x^2 + 1"


# -- (d) the noise budget against seal_tpu ----------------------------------------------------

@pytest.mark.parametrize("scheme", ["BFV", "BGV"])
def test_noise_budget_matches_seal_tpu(scheme):
    """fresh (public and secret key), multiply, relinearize: the port's
    budget of each equals seal_tpu's Decryptor's on the same ciphertext
    (two shapes, [2, 3, N] and [3, 3, N], each a jit compile of seal_tpu's;
    the mod switch's budgets are held against SEAL's chain above)."""
    ctx, sctx = _contexts(scheme, 1, (8,) * 8)
    kg = st.KeyGenerator(ctx)
    sk = kg.secret_key()
    enc = st.Encryptor(ctx, kg.create_public_key(), sk)
    ev, be, dec = st.Evaluator(ctx), st.BatchEncoder(ctx), st.Decryptor(ctx, sk)
    sdec = seal_tpu.Decryptor(sctx, seal_tpu.KeyGenerator(sctx).secret_key())
    fresh = enc.encrypt(be.encode(np.arange(N_HOST) % 97))
    fresh_sym = enc.encrypt_symmetric(be.encode([3, 4, 5]))
    mul = ev.multiply(fresh, fresh_sym)
    relin = ev.relinearize(mul, kg.create_relin_keys())
    budgets = []
    for c in (fresh, fresh_sym, mul, relin):
        sct = seal_tpu.Ciphertext(to_device(c.to_numpy()), tuple(c.parms_id), False, 1.0,
                                  c.correction_factor)
        budgets.append(dec.invariant_noise_budget(c))
        assert budgets[-1] == sdec.invariant_noise_budget(sct)
    last = dec.invariant_noise_budget(ev.mod_switch_to_next(relin))
    assert min(budgets[:2]) > budgets[2] >= budgets[3] > last > 0


# -- (e) the API -----------------------------------------------------------------------------

def test_keygenerator_and_encryptor_api():
    ctx, _ = _contexts("CKKS", 1, None)
    kg = st.KeyGenerator(ctx)
    other = st.KeyGenerator(ctx)
    assert not np.array_equal(kg.secret_key().to_numpy(), other.secret_key().to_numpy())
    again = st.KeyGenerator(ctx, kg.secret_key())
    assert again.secret_key() is kg.secret_key()
    pk = kg.create_public_key(save_seed=True)
    assert pk.data.seed_info[0] == int(st.PrngType.BLAKE2XB) and len(pk.data.seed_info[1]) == 8
    assert kg.create_public_key().data.seed_info is None
    rk = kg.create_relin_keys(save_seed=True)
    assert len(rk.seeds) == 1 and len(rk.seeds[0]) == 3
    gk = kg.create_galois_keys(steps=[1], save_seed=True)
    elt = ctx.key_context_data().galois_tool.get_elt_from_step(1)
    assert gk.seeds[st.GaloisKeys.get_index(elt)] is not None and gk.seeds[2] is None
    with pytest.raises(ValueError, match="invalid count"):
        kg.create_relin_keys(count=0)
    assert len(kg.create_relin_keys(count=2).keys) == 2

    dec = st.Decryptor(ctx, kg.secret_key())
    cd = ctx.first_context_data().next_context_data
    zero = st.Encryptor(ctx, pk).encrypt_zero(cd.parms_id)
    assert tuple(zero.parms_id) == tuple(cd.parms_id) and zero.is_ntt_form
    phase = ntt.ntt_inverse(dec.decrypt(zero).data, cd.ntt_tables)
    q = torch.tensor(cd.key_moduli()).reshape(-1, 1)
    assert torch.minimum(phase, q - phase).max() < 1 << 10
    with pytest.raises(RuntimeError, match="public key is not set"):
        st.Encryptor(ctx, kg.secret_key()).encrypt(st.CKKSEncoder(ctx).encode([1.0], 2.0 ** 20))
    with pytest.raises(RuntimeError, match="secret key is not set"):
        st.Encryptor(ctx, pk).encrypt_zero_symmetric()
    with pytest.raises(TypeError):
        st.Encryptor(ctx, kg.create_relin_keys())
    assert interop.public_key_from_numpy(ctx, pk.to_numpy()).to_numpy().tobytes() == \
        pk.to_numpy().tobytes()
