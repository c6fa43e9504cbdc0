"""The port's CKKS multiply -> relinearize -> rescale as a whole, on the CPU.

(a) α = 1 against SEAL's own golden vectors (tests/vectors/ckks_n64.json):
    multiply, relinearize, rescale and decrypt bit for bit.
(b) α = 1 at n = 1024 against seal_tpu.Evaluator, bit for bit: from one
    random seed seal_tpu and the port each make the relinearization key,
    the public key, the encodes and the public-key ciphertexts, which must
    agree bit for bit before the pipeline runs; α = 2 is in
    test_torch_hybrid_keyswitch.py, a file of its own so that the two slow
    JAX compiles land on different test workers.
(c) The port's own keygen, symmetric encryption and decryption from a
    random seed, alone and around the pipeline, within a stated noise bound.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

import seal_tpu
import seal_tpu_torch as st
from seal_tpu.dtypes import to_host
from seal_tpu_torch import interop
from seal_tpu_torch.ops import ntt

V = json.loads((pathlib.Path(__file__).parent / "vectors" / "ckks_n64.json").read_text())


def _ref(name, L, n=64):
    return np.array(V[name], dtype=np.uint64).reshape(L, n)


def _assert_ct(ct, name):
    arr = ct.to_numpy()
    for j in range(ct.size):
        np.testing.assert_array_equal(arr[j].reshape(-1), np.array(V[f"{name}_c{j}"], dtype=np.uint64),
                                      err_msg=f"{name}_c{j}")


def _port_context(n, bits, alpha=1, sec_level=st.SecLevelType.NONE, seed=None):
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
    parms.set_special_modulus_size(alpha)
    parms.set_random_seed(seed)
    return st.SEALContext(parms, sec_level=sec_level, device="cpu")


# -- (a) SEAL golden vectors ---------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    ctx = _port_context(64, [40, 40, 40, 40])
    sk = interop.secret_key_from_numpy(ctx, _ref("secret_key", 4))
    rk = interop.relin_keys_from_numpy(ctx, [np.stack([
        np.stack([_ref(f"relin_key_{i}_c{c}", 4) for c in range(2)]) for i in range(3)])])
    scale = 2.0 ** V["scale_log2"]

    def ct(name):
        return interop.ciphertext_from_numpy(
            ctx, np.stack([_ref(f"{name}_c{j}", 3) for j in range(2)]),
            ctx.first_parms_id, scale)

    return ctx, sk, rk, ct("ct1"), ct("ct2")


def test_golden_parms_id_and_chain(golden):
    ctx = golden[0]
    sp = seal_tpu.EncryptionParameters(seal_tpu.SchemeType.CKKS)
    sp.set_poly_modulus_degree(64)
    sp.set_coeff_modulus(seal_tpu.CoeffModulus.create(64, [40, 40, 40, 40]))
    sctx = seal_tpu.SEALContext(sp, sec_level=seal_tpu.SecLevelType.NONE)
    for a, b in ((ctx.key_context_data(), sctx.key_context_data()),
                 (ctx.first_context_data(), sctx.first_context_data())):
        assert tuple(a.parms_id) == tuple(b.parms_id)
        assert a.key_moduli() == b.key_moduli()
        assert a.chain_index == b.chain_index


def test_golden_multiply_relinearize_rescale_decrypt(golden):
    ctx, sk, rk, ct1, ct2 = golden
    ev = st.Evaluator(ctx)
    mul = ev.multiply(ct1, ct2)
    _assert_ct(mul, "mul")
    relin = ev.relinearize(mul, rk)
    _assert_ct(relin, "relin")
    res = ev.rescale_to_next(relin)
    _assert_ct(res, "rescale")
    assert res.scale == V["rescale_scale"]
    dec = st.Decryptor(ctx, sk).decrypt(res)
    np.testing.assert_array_equal(dec.to_numpy().reshape(-1),
                                  np.array(V["rescale_decrypted"], dtype=np.uint64))


@pytest.mark.parametrize("op", ["add", "negate", "mod_switch_to_next"])
def test_golden_add_negate_modswitch(golden, op):
    ctx, _, _, ct1, ct2 = golden
    ev = st.Evaluator(ctx)
    out = {"add": lambda: ev.add(ct1, ct2), "negate": lambda: ev.negate(ct1),
           "mod_switch_to_next": lambda: ev.mod_switch_to_next(ct1)}[op]()
    _assert_ct(out, {"mod_switch_to_next": "modswitch"}.get(op, op))


def test_golden_square_equals_multiply(golden):
    """CKKS square: three dyadic products, multiply(a, a)'s bits and scale."""
    ctx, _, _, ct1, _ = golden
    ev = st.Evaluator(ctx)
    sq, mul = ev.square(ct1), ev.multiply(ct1, ct1)
    np.testing.assert_array_equal(sq.to_numpy(), mul.to_numpy())
    assert sq.scale == mul.scale


# -- (b) against seal_tpu at n = 1024 ------------------------------------------

def seeded_state_matches_seal_tpu(sctx, ctx, values, scale, galois_steps=None):
    """seal_tpu and the port each make the relinearization key (and Galois
    keys of `galois_steps`), the public key and a public-key encryption of
    each vector of `values` from the parameters' random seed; every key and
    ciphertext must be bit-identical. Returns (seal_tpu's, the port's)
    (relin keys, Galois keys, ciphertexts)."""
    skg, kg = seal_tpu.KeyGenerator(sctx), st.KeyGenerator(ctx)
    out = []
    for keygen, encoder_cls, encryptor_cls in (
            (skg, seal_tpu.CKKSEncoder, seal_tpu.Encryptor),
            (kg, st.CKKSEncoder, st.Encryptor)):
        rk = keygen.create_relin_keys()
        gk = None if galois_steps is None else keygen.create_galois_keys(steps=galois_steps)
        enc, encoder = encryptor_cls(ctx if keygen is kg else sctx,
                                     keygen.create_public_key()), \
            encoder_cls(ctx if keygen is kg else sctx)
        out.append((rk, gk, [enc.encrypt(encoder.encode(v, scale)) for v in values]))
    (srk, sgk, scts), (rk, gk, cts) = out
    np.testing.assert_array_equal(rk.keys[0].numpy().view(np.uint64), to_host(srk.keys[0]))
    if gk is not None:
        for k, sk in zip(gk.keys, sgk.keys):
            assert (k is None) == (sk is None)
            if k is not None:
                np.testing.assert_array_equal(k.numpy().view(np.uint64), to_host(sk))
    for ct, sct in zip(cts, scts):
        np.testing.assert_array_equal(ct.to_numpy(), sct.to_numpy())
        assert tuple(ct.parms_id) == tuple(sct.parms_id) and ct.scale == sct.scale
    return (srk, sgk, scts), (rk, gk, cts)


def assert_pipeline_matches_seal_tpu(alpha, bits, n=1024):
    """seal_tpu runs multiply, relinearize, rescale_to_next and
    relinearize_rescale (under one jax.jit, which compiles once instead of
    op by op); the port repeats them on its own keys and ciphertexts from
    the same seed and must give the same bits and metadata."""
    seed = (7, 1, 2, 3, 4, 5, 6, alpha)
    sp = seal_tpu.EncryptionParameters(seal_tpu.SchemeType.CKKS)
    sp.set_poly_modulus_degree(n)
    sp.set_coeff_modulus(seal_tpu.CoeffModulus.create(n, bits))
    sp.set_special_modulus_size(alpha)
    sp.set_random_seed(seed)
    sctx = seal_tpu.SEALContext(sp, sec_level=seal_tpu.SecLevelType.NONE)
    ctx = _port_context(n, bits, alpha, seed=seed)
    assert tuple(ctx.first_parms_id) == tuple(sctx.first_parms_id)
    rng = np.random.default_rng(alpha * 10 + len(bits))
    values = [rng.uniform(-1, 1, n // 2) for _ in range(2)]
    (srk, _, (sct1, sct2)), (rk, _, (ct1, ct2)) = seeded_state_matches_seal_tpu(
        sctx, ctx, values, 2.0 ** 30)
    sev = seal_tpu.Evaluator(sctx)

    def pipeline(ev, rk, a, b):
        mul = ev.multiply(a, b)
        relin = ev.relinearize(mul, rk)
        return {"multiply": mul, "relinearize": relin,
                "rescale_to_next": ev.rescale_to_next(relin),
                "relinearize_rescale": ev.relinearize_rescale(mul, rk)}

    want = jax.jit(lambda a, b: pipeline(sev, srk, a, b))(sct1, sct2)
    got = pipeline(st.Evaluator(ctx), rk, ct1, ct2)
    for op, ct in got.items():
        np.testing.assert_array_equal(ct.to_numpy(), want[op].to_numpy(), err_msg=op)
        assert tuple(ct.parms_id) == tuple(want[op].parms_id), op
        assert ct.scale == want[op].scale, op


def test_pipeline_matches_seal_tpu_alpha1():
    """SEAL's key switching: 3 data primes and 1 special prime."""
    assert_pipeline_matches_seal_tpu(1, [40, 40, 40, 40])


# -- (c) the port's own keys and encryption ------------------------------------

N_RT = 1024
FRESH_NOISE_BOUND = 21              # phase - m = -e, one CBD sample: |e| <= 21
PIPELINE_NOISE_BOUND = 1 << 12      # after multiply, relinearize, rescale


def _sparse(rng, count=4, bits=30):
    idx = rng.permutation(N_RT)[:count].tolist()
    mag = rng.integers(1 << (bits - 1), 1 << bits, count).tolist()
    sign = rng.integers(0, 2, count).tolist()
    return {i: (m if s else -m) for i, m, s in zip(idx, mag, sign)}


def _encode(cd, coeffs, scale):
    rows = torch.zeros((cd.coeff_modulus_size, N_RT), dtype=torch.int64)
    for i, v in coeffs.items():
        rows[:, i] = torch.tensor([v % q for q in cd.key_moduli()])
    return st.Plaintext(ntt.ntt_forward(rows, cd.ntt_tables), tuple(cd.parms_id), scale)


def _centered_row0(ctx, plain):
    cd = ctx.get_context_data(plain.parms_id)
    q0 = cd.key_moduli()[0]
    coeffs = ntt.ntt_inverse(plain.data, cd.ntt_tables)[0].tolist()
    return [v - q0 if v > q0 // 2 else v for v in coeffs]


@pytest.mark.parametrize("level", [0, 1], ids=["first_level", "second_level"])
@pytest.mark.parametrize("alpha,bits", [(1, [50] * 4 + [60]), (2, [50] * 4 + [55] * 2)])
def test_own_keys_round_trip_and_pipeline(alpha, bits, level):
    """At the second level the key's rows are gathered to the level's
    extended tower before the inner product."""
    ctx = _port_context(N_RT, bits, alpha, seed=(alpha,) * 8)
    kg = st.KeyGenerator(ctx)
    sk, rk = kg.secret_key(), kg.create_relin_keys()
    assert rk.keys[0].shape == (-(-4 // alpha), 2, 4 + alpha, N_RT)
    enc, dec, ev = st.Encryptor(ctx, sk), st.Decryptor(ctx, sk), st.Evaluator(ctx)
    cd = ctx.first_context_data()
    for _ in range(level):
        cd = cd.next_context_data
    rng = np.random.default_rng(alpha)
    m1, m2 = _sparse(rng), _sparse(rng)
    ct1 = enc.encrypt_symmetric(_encode(cd, m1, 2.0 ** 30))
    ct2 = enc.encrypt_symmetric(_encode(cd, m2, 2.0 ** 30))

    fresh = _centered_row0(ctx, dec.decrypt(ct1))
    assert max(abs(fresh[i] - m1.get(i, 0)) for i in range(N_RT)) <= FRESH_NOISE_BOUND

    exact = {}
    for i, a in m1.items():
        for j, b in m2.items():
            k, v = (i + j, a * b) if i + j < N_RT else (i + j - N_RT, -a * b)
            exact[k] = exact.get(k, 0) + v
    q_last = cd.key_moduli()[-1]
    mul = ev.multiply(ct1, ct2)
    for out in (ev.rescale_to_next(ev.relinearize(mul, rk)), ev.relinearize_rescale(mul, rk)):
        assert tuple(out.parms_id) == tuple(cd.next_context_data.parms_id)
        got = _centered_row0(ctx, dec.decrypt(out))
        err = max(abs(got[i] - exact.get(i, 0) / q_last) for i in range(N_RT))
        assert err <= PIPELINE_NOISE_BOUND
        assert out.scale == 2.0 ** 60 / q_last
