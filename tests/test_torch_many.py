"""The port's batch APIs on the CPU against seal_tpu's, bit for bit
(tolerance 0): BatchEncoder.encode_many / decode_many, CKKSEncoder
.encode_many / decode_many, Encryptor.encrypt_many / encrypt_symmetric_many
(save_seed too) and Decryptor.decrypt_many.

It mirrors tests/test_batch_api.py: B = 13, SEAL's seeded stream, CKKS, BFV
and BGV at n = 64, public-key and symmetric. Every result equals seal_tpu's
*_many and the port's own sequential calls; lists that mix levels or scales
fall back to the sequential calls, as seal_tpu's do. No seal_tpu Evaluator
runs.
"""

import numpy as np
import pytest
import torch

import seal_tpu
import seal_tpu_torch as st

SEED = (1, 2, 3, 4, 5, 6, 7, 8)
B = 13
N = 64


def _contexts(scheme, bits, plain=None):
    """(seal_tpu's context, the port's) from one seeded parameter set."""
    out = []
    for lib, kw in ((seal_tpu, {}), (st, {"device": "cpu"})):
        parms = lib.EncryptionParameters(getattr(lib.SchemeType, scheme))
        parms.set_poly_modulus_degree(N)
        parms.set_coeff_modulus(lib.CoeffModulus.create(N, list(bits)))
        if plain is not None:
            parms.set_plain_modulus(plain)
        parms.set_random_seed(SEED)
        out.append(lib.SEALContext(parms, sec_level=lib.SecLevelType.NONE, **kw))
    return out


def _keys(sctx, ctx):
    """Both libraries' (secret key, public key) from the seed, equal."""
    skg, kg = seal_tpu.KeyGenerator(sctx), st.KeyGenerator(ctx)
    spk, pk = skg.create_public_key(), kg.create_public_key()
    np.testing.assert_array_equal(kg.secret_key().to_numpy(), skg.secret_key().to_numpy())
    np.testing.assert_array_equal(pk.data.to_numpy(), spk.data.to_numpy())
    return (skg.secret_key(), spk), (kg.secret_key(), pk)


def _assert_cts(got, singles, theirs):
    assert len(got) == len(singles) == len(theirs)
    for b, (g, s, t) in enumerate(zip(got, singles, theirs)):
        np.testing.assert_array_equal(g.to_numpy(), s.to_numpy(), err_msg=f"member {b}")
        np.testing.assert_array_equal(g.to_numpy(), t.to_numpy(), err_msg=f"member {b}")
        assert tuple(g.parms_id) == tuple(s.parms_id) == tuple(t.parms_id)
        assert g.scale == s.scale == t.scale and g.is_ntt_form == t.is_ntt_form
        assert g.seed_info == s.seed_info


def _hex_plains(b_count, make):
    texts = [make(b) for b in range(b_count)]
    return ([seal_tpu.Plaintext.from_hex_string(x) for x in texts],
            [st.Plaintext.from_hex_string(x, device="cpu") for x in texts])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the suite's other worker processes, a
    thread per core waits at every op's barrier for threads that are not
    running (tests/test_torch_keys_seeded.py does the same)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- BatchEncoder -------------------------------------------------------------------

def test_batchencoder_many_matches_seal_tpu():
    sctx, ctx = _contexts("BFV", (40, 40), plain=st.PlainModulus.batching(N, 20).value)
    sbe, be = seal_tpu.BatchEncoder(sctx), st.BatchEncoder(ctx)
    t = ctx.key_context_data().parms.plain_modulus.value
    rng = np.random.default_rng(0)
    vals = rng.integers(0, t, (B, N), dtype=np.int64)
    half = (t - 1) // 2
    svals = rng.integers(-half, half + 1, (B, N), dtype=np.int64)
    for values in (vals, svals, vals[:, :5]):
        batch, theirs = be.encode_many(values), sbe.encode_many(values)
        for b in range(B):
            want = be.encode(values[b]).to_numpy()
            np.testing.assert_array_equal(batch[b].to_numpy(), want)
            np.testing.assert_array_equal(batch[b].to_numpy(), np.asarray(theirs[b].data))
        for signed in (False, True):
            dec = be.decode_many(batch, signed=signed).numpy()
            np.testing.assert_array_equal(dec, sbe.decode_many(theirs, signed=signed))
            for b in range(B):
                np.testing.assert_array_equal(dec[b], be.decode(batch[b], signed=signed).numpy())
    np.testing.assert_array_equal(be.decode_many(be.encode_many(svals), signed=True).numpy(),
                                  svals)
    # a short plaintext among full ones
    short = st.Plaintext(torch.tensor([3, 0, 7]))
    mixed = be.decode_many([short] + be.encode_many(vals[:2]))
    np.testing.assert_array_equal(mixed[0].numpy(), be.decode(short).numpy())
    for bad in (np.full((2, N), t), np.zeros(N, dtype=np.int64), np.zeros((2, N + 1))):
        with pytest.raises(ValueError):
            be.encode_many(bad)
    assert be.decode_many([]).shape == (0, N)


# -- encrypt_many / decrypt_many ---------------------------------------------------

@pytest.mark.parametrize("asymmetric", [True, False], ids=["public", "symmetric"])
@pytest.mark.parametrize("scheme", ["BFV", "BGV"])
def test_exact_encrypt_decrypt_many_matches_seal_tpu(scheme, asymmetric):
    sctx, ctx = _contexts(scheme, (40, 40, 40), plain=257)
    (ssk, spk), (sk, pk) = _keys(sctx, ctx)
    senc, enc = seal_tpu.Encryptor(sctx, spk, ssk), st.Encryptor(ctx, pk, sk)
    sdec, dec = seal_tpu.Decryptor(sctx, ssk), st.Decryptor(ctx, sk)
    splains, plains = _hex_plains(B, lambda b: f"{(29 * b + 5) % 257:X}x^{b % 5} + {b + 1:X}")
    name = "encrypt_many" if asymmetric else "encrypt_symmetric_many"
    one = "encrypt" if asymmetric else "encrypt_symmetric"
    cts = getattr(enc, name)(plains)
    _assert_cts(cts, [getattr(enc, one)(p) for p in plains], getattr(senc, name)(splains))
    outs, theirs = dec.decrypt_many(cts), sdec.decrypt_many(getattr(senc, name)(splains))
    for b, (o, th, p) in enumerate(zip(outs, theirs, plains)):
        np.testing.assert_array_equal(o.to_numpy(), np.asarray(th.data), err_msg=str(b))
        np.testing.assert_array_equal(o.to_numpy(), dec.decrypt(cts[b]).to_numpy())
        assert o.to_hex_string() == p.to_hex_string()


@pytest.mark.parametrize("asymmetric", [True, False], ids=["public", "symmetric"])
def test_ckks_encode_encrypt_decrypt_decode_many_matches_seal_tpu(asymmetric):
    sctx, ctx = _contexts("CKKS", (40, 30, 40))
    (ssk, spk), (sk, pk) = _keys(sctx, ctx)
    sce, ce = seal_tpu.CKKSEncoder(sctx), st.CKKSEncoder(ctx)
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(B, N // 2)) + 1j * rng.normal(size=(B, N // 2))
    scale = 2.0 ** 30
    plains, splains = ce.encode_many(vals, scale), sce.encode_many(vals, scale)
    for b in range(B):
        np.testing.assert_array_equal(plains[b].to_numpy(), ce.encode(vals[b], scale).to_numpy())
        np.testing.assert_array_equal(plains[b].to_numpy(), splains[b].host_rns_u64())
    senc, enc = seal_tpu.Encryptor(sctx, spk, ssk), st.Encryptor(ctx, pk, sk)
    name = "encrypt_many" if asymmetric else "encrypt_symmetric_many"
    one = "encrypt" if asymmetric else "encrypt_symmetric"
    cts = getattr(enc, name)(plains)
    _assert_cts(cts, [getattr(enc, one)(p) for p in plains], getattr(senc, name)(splains))
    sdec, dec = seal_tpu.Decryptor(sctx, ssk), st.Decryptor(ctx, sk)
    outs, theirs = dec.decrypt_many(cts), sdec.decrypt_many(getattr(senc, name)(splains))
    for b in range(B):
        np.testing.assert_array_equal(outs[b].to_numpy(), dec.decrypt(cts[b]).to_numpy())
        np.testing.assert_array_equal(outs[b].to_numpy(), theirs[b].host_rns_u64())
        assert outs[b].scale == theirs[b].scale
    for complex_out in (False, True):
        got = ce.decode_many(outs, complex_out=complex_out).numpy()
        np.testing.assert_array_equal(got, sce.decode_many(theirs, complex_out=complex_out))
        for b in range(B):
            np.testing.assert_array_equal(got[b], ce.decode(outs[b], complex_out).numpy())
    assert np.max(np.abs(ce.decode_many(outs, complex_out=True).numpy() - vals)) < 1e-4


def test_encrypt_symmetric_many_save_seed_matches_seal_tpu():
    for scheme, plain in (("BFV", 257), ("CKKS", None)):
        sctx, ctx = _contexts(scheme, (40, 40, 40), plain=plain)
        (ssk, _), (sk, _) = _keys(sctx, ctx)
        if scheme == "BFV":
            splains, plains = _hex_plains(3, lambda b: f"2x^1 + {b + 1:X}")
        else:
            vals = np.arange(3 * N // 2).reshape(3, N // 2) / 100.0
            plains = st.CKKSEncoder(ctx).encode_many(vals, 2.0 ** 30)
            splains = seal_tpu.CKKSEncoder(sctx).encode_many(vals, 2.0 ** 30)
        enc = st.Encryptor(ctx, sk)
        cts = enc.encrypt_symmetric_many(plains, save_seed=True)
        theirs = seal_tpu.Encryptor(sctx, ssk).encrypt_symmetric_many(splains, save_seed=True)
        _assert_cts(cts, [enc.encrypt_symmetric(p, save_seed=True) for p in plains], theirs)
        for c, th in zip(cts, theirs):
            assert c.seed_info is not None and c.seed_info == tuple(th.seed_info)


def test_mixed_levels_and_scales_fall_back():
    """CKKS plaintexts at two levels: encrypt_many refuses them (one common
    level), as seal_tpu's does; decrypt_many and decode_many of lists that
    mix levels or scales give the sequential calls' results."""
    sctx, ctx = _contexts("CKKS", (40, 30, 40))
    (ssk, spk), (sk, pk) = _keys(sctx, ctx)
    ce, enc, dec = st.CKKSEncoder(ctx), st.Encryptor(ctx, pk), st.Decryptor(ctx, sk)
    second = ctx.first_context_data().next_context_data.parms_id
    vals = np.linspace(-1, 1, N // 2)
    low = ce.encode(vals, 2.0 ** 20, parms_id=second)
    plains = [ce.encode(vals, 2.0 ** 30), low, ce.encode(vals[::-1], 2.0 ** 25)]
    with pytest.raises(ValueError, match="one common level"):
        enc.encrypt_many(plains)
    sce = seal_tpu.CKKSEncoder(sctx)
    splains = [sce.encode(vals, 2.0 ** 30), sce.encode(vals, 2.0 ** 20, parms_id=second)]
    with pytest.raises(ValueError, match="one common level"):
        seal_tpu.Encryptor(sctx, spk).encrypt_many(splains)
    cts = [enc.encrypt(p) for p in plains]
    outs = dec.decrypt_many(cts)
    for o, c in zip(outs, cts):
        np.testing.assert_array_equal(o.to_numpy(), dec.decrypt(c).to_numpy())
        assert tuple(o.parms_id) == tuple(c.parms_id) and o.scale == c.scale
    got = ce.decode_many(outs).numpy()
    for b, o in enumerate(outs):
        np.testing.assert_array_equal(got[b], ce.decode(o).numpy())
    assert ce.decode_many([]).shape == (0, N // 2)
    assert dec.decrypt_many([]) == [] and enc.encrypt_many([]) == []


def test_bgv_decrypt_many_with_correction_factors():
    """Members at one level whose correction factors differ (a switched
    ciphertext and the square of one) decrypt as one batch, each with its
    own factor undone, equal to sequential decrypt; members at two levels
    fall back."""
    _, ctx = _contexts("BGV", (40, 40, 40), plain=257)
    kg = st.KeyGenerator(ctx)
    enc, dec, ev = st.Encryptor(ctx, kg.create_public_key()), st.Decryptor(ctx, kg.secret_key()), \
        st.Evaluator(ctx)
    _, plains = _hex_plains(3, lambda b: f"{b + 3:X}x^2 + 1")
    cts = enc.encrypt_many(plains)
    rk = kg.create_relin_keys()
    low = [ev.mod_switch_to_next(cts[0]),
           ev.relinearize(ev.square(ev.mod_switch_to_next(cts[1])), rk)]
    assert 1 != low[0].correction_factor != low[1].correction_factor != 1
    for batch in (low, [cts[2], low[0]]):
        for o, c in zip(dec.decrypt_many(batch), batch):
            np.testing.assert_array_equal(o.to_numpy(), dec.decrypt(c).to_numpy())
