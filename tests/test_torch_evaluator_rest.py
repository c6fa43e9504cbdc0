"""The rest of the port's Evaluator, and the trimmed BFV/BGV decryption, on
the CPU against seal_tpu and SEAL's vectors, bit for bit (tolerance 0).

(a) decrypt trims a BFV/BGV plaintext as seal_tpu does: up to its last
    nonzero coefficient, one coefficient when all are zero (n = 64, against
    seal_tpu's Decryptor.decrypt: length and values).
(b) CKKS at n = 1024 against seal_tpu: add_many (seal_tpu's eager add),
    mod_switch_plain_to_next / mod_switch_plain_to, and the binary tree of
    multiply_many and exponentiate, traced with symbols through both
    libraries' methods (the port's multiply and relinearize are held to
    seal_tpu's bits by test_torch_evaluator.py); every `*_inplace` twin of
    seal_tpu's list, each equal to its op with its argument's identity kept;
    throw_on_transparent_ciphertext defaults as seal_tpu's.
(c) SEAL's vectors at n = 64: multiply_many of the two ciphertexts is
    SEAL's relinearized product (CKKS and BFV), rescale_to is SEAL's
    rescale, add_many is SEAL's sum.
(d) rotate_batch_hoisted on coefficient-form ciphertexts: BFV against
    seal_tpu's coefficient branches (both: up to 16 steps and the 17-step
    loop) under one small jax.jit at n = 64; BFV and BGV decryptions equal
    rotate_rows' at every step. No seal_tpu BFV/BGV Evaluator runs eagerly.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

import seal_tpu
import seal_tpu.evaluator
import seal_tpu_torch as st
from seal_tpu.config import config as seal_tpu_config
from seal_tpu.dtypes import to_host
from seal_tpu_torch import interop
from seal_tpu_torch.config import config
from tests.test_torch_bfv import SEED, V, assert_ct, port_context, ref
from tests.test_torch_evaluator import seeded_state_matches_seal_tpu

VECTORS = pathlib.Path(__file__).parent / "vectors"
VC = json.loads((VECTORS / "ckks_n64.json").read_text())


def _seal_tpu_context(scheme, n, bits, t=None, alpha=1, seed=SEED):
    parms = seal_tpu.EncryptionParameters(getattr(seal_tpu.SchemeType, scheme))
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(seal_tpu.CoeffModulus.create(n, bits))
    if t is not None:
        parms.set_plain_modulus(t)
    parms.set_special_modulus_size(alpha)
    parms.set_random_seed(seed)
    return seal_tpu.SEALContext(parms, sec_level=seal_tpu.SecLevelType.NONE)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the suite's other worker processes, a
    thread per core waits at every op's barrier for threads that are not
    running (tests/test_torch_keys_seeded.py does the same)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- (a) trimmed decryption ----------------------------------------------------------

@pytest.mark.parametrize("scheme", ["BFV", "BGV"])
@pytest.mark.parametrize("text", ["3x^5 + 1", "1Fx^62 + 7x^1", "0", "5"])
def test_decrypt_trims_as_seal_tpu(scheme, text):
    ctx = port_context(st.SchemeType[scheme], 64, [40, 40, 40], 257, seed=SEED)
    sctx = _seal_tpu_context(scheme, 64, [40, 40, 40], 257)
    kg, skg = st.KeyGenerator(ctx), seal_tpu.KeyGenerator(sctx)
    ct = st.Encryptor(ctx, kg.create_public_key()).encrypt(
        st.Plaintext.from_hex_string(text, device="cpu"))
    sct = seal_tpu.Encryptor(sctx, skg.create_public_key()).encrypt(
        seal_tpu.Plaintext.from_hex_string(text))
    np.testing.assert_array_equal(ct.to_numpy(), sct.to_numpy())
    got = st.Decryptor(ctx, kg.secret_key()).decrypt(ct)
    want = np.asarray(seal_tpu.Decryptor(sctx, skg.secret_key()).decrypt(sct).data)
    assert got.data.shape == want.shape
    np.testing.assert_array_equal(got.to_numpy(), want)
    assert got.to_hex_string() == text


# -- (b) CKKS at n = 1024 against seal_tpu ----------------------------------------------

@pytest.fixture(scope="module")
def ckks():
    n, bits, seed = 1024, [40, 40, 40, 40], (8, 1, 2, 3, 4, 5, 6, 7)
    sctx = _seal_tpu_context("CKKS", n, bits, seed=seed)
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
    parms.set_random_seed(seed)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    rng = np.random.default_rng(8)
    values = [rng.uniform(-1, 1, n // 2) for _ in range(3)]
    (srk, _, scts), (rk, _, cts) = seeded_state_matches_seal_tpu(sctx, ctx, values, 2.0 ** 30)
    return dict(sctx=sctx, ctx=ctx, srk=srk, rk=rk, scts=scts, cts=cts, values=values)


def test_add_many_matches_seal_tpu(ckks):
    got = st.Evaluator(ckks["ctx"]).add_many(ckks["cts"])
    want = seal_tpu.Evaluator(ckks["sctx"]).add_many(ckks["scts"])
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    assert got.scale == want.scale
    with pytest.raises(ValueError, match="cannot be empty"):
        st.Evaluator(ckks["ctx"]).add_many([])


def test_mod_switch_plain_matches_seal_tpu(ckks):
    ctx, sctx = ckks["ctx"], ckks["sctx"]
    plain = st.CKKSEncoder(ctx).encode(ckks["values"][0], 2.0 ** 30)
    splain = seal_tpu.CKKSEncoder(sctx).encode(ckks["values"][0], 2.0 ** 30)
    ev, sev = st.Evaluator(ctx), seal_tpu.Evaluator(sctx)
    nxt, snxt = ev.mod_switch_plain_to_next(plain), sev.mod_switch_plain_to_next(splain)
    np.testing.assert_array_equal(nxt.to_numpy(), to_host(snxt.rns_data))
    assert tuple(nxt.parms_id) == tuple(snxt.parms_id) and nxt.scale == snxt.scale
    last = ctx.last_parms_id
    low, slow = ev.mod_switch_plain_to(plain, last), sev.mod_switch_plain_to(splain, last)
    np.testing.assert_array_equal(low.to_numpy(), to_host(slow.rns_data))
    assert tuple(low.parms_id) == tuple(slow.parms_id) == tuple(last)
    assert ev.mod_switch_plain_to(plain, ctx.first_parms_id) is plain
    for fn, arg, msg in ((ev.mod_switch_plain_to_next, low, "end of modulus switching"),
                         (lambda p: ev.mod_switch_plain_to(p, ctx.first_parms_id), low,
                          "higher level"),
                         (ev.mod_switch_plain_to_next, st.Plaintext(torch.zeros(4)),
                          "not in NTT form")):
        with pytest.raises(ValueError, match=msg):
            fn(arg)


class _Sym(str):
    def copy(self):
        return _Sym(self)


class _Tracer:
    """Stands in for an Evaluator: multiply and relinearize build strings,
    so a library's multiply_many shows the tree it walks."""

    def multiply(self, a, b):
        return _Sym(f"({a}*{b})")

    def relinearize(self, x, relin_keys):
        return _Sym(f"r{x}")


@pytest.mark.parametrize("count", [1, 2, 3, 5, 7, 8])
def test_multiply_many_and_exponentiate_walk_seal_tpu_tree(count):
    names = [_Sym(chr(ord("a") + i)) for i in range(count)]
    trees = []
    for lib in (seal_tpu.Evaluator, st.Evaluator):
        tracer = type("T", (_Tracer,), {"multiply_many": lib.multiply_many})()
        trees.append((lib.multiply_many(tracer, names, None),
                      lib.exponentiate(tracer, _Sym("x"), count, None)))
    assert trees[0] == trees[1]


def test_multiply_many_and_exponentiate_values(ckks):
    """The port's tree on real ciphertexts: multiply_many of three equals
    relinearize(relinearize(a·b)·c), and exponentiate(ct, 3) the same of
    one ciphertext."""
    ctx, rk, (a, b, c) = ckks["ctx"], ckks["rk"], ckks["cts"]
    ev = st.Evaluator(ctx)
    want = ev.relinearize(ev.multiply(ev.relinearize(ev.multiply(a, b), rk), c), rk)
    np.testing.assert_array_equal(ev.multiply_many([a, b, c], rk).to_numpy(), want.to_numpy())
    cube = ev.exponentiate(a, 3, rk)
    np.testing.assert_array_equal(
        cube.to_numpy(),
        ev.relinearize(ev.multiply(ev.relinearize(ev.multiply(a, a), rk), a), rk).to_numpy())
    assert ev.exponentiate(a, 1, rk).to_numpy().tobytes() == a.to_numpy().tobytes()
    with pytest.raises(ValueError, match="exponent cannot be 0"):
        ev.exponentiate(a, 0, rk)
    with pytest.raises(ValueError, match="cannot be empty"):
        ev.multiply_many([], rk)


def test_inplace_twins_match_seal_tpu_list(ckks):
    """The same `*_inplace` names as seal_tpu's; each runs its op and
    rebinds the result onto its argument."""
    assert seal_tpu.evaluator._INPLACE_METHODS == st.evaluator._INPLACE_METHODS
    ctx, rk, (a, b, _) = ckks["ctx"], ckks["rk"], ckks["cts"]
    ev = st.Evaluator(ctx)
    gk = st.KeyGenerator(ctx).create_galois_keys(steps=[1, 0])
    plain = st.CKKSEncoder(ctx).encode(ckks["values"][2], 2.0 ** 30)
    mul = ev.multiply(a, b)
    cases = {"negate": (a,), "add": (a, b), "sub": (a, b), "multiply": (a, b), "square": (a,),
             "relinearize": (mul, rk), "mod_switch_to_next": (a,),
             "mod_switch_to": (a, ctx.last_parms_id), "rescale_to_next": (mul,),
             "rescale_to": (mul, ctx.last_parms_id), "add_plain": (a, plain),
             "sub_plain": (a, plain), "multiply_plain": (a, plain),
             "transform_from_ntt": (a,), "apply_galois": (a, 3, gk),
             "rotate_vector": (a, 1, gk), "complex_conjugate": (a, gk),
             "exponentiate": (a, 2, rk)}
    for name, (ct, *args) in cases.items():
        want = getattr(ev, name)(ct, *args)
        target = ct.copy()
        assert getattr(ev, name + "_inplace")(target, *args) is target
        np.testing.assert_array_equal(target.to_numpy(), want.to_numpy(), err_msg=name)
        assert (tuple(target.parms_id), target.scale, target.is_ntt_form) == \
            (tuple(want.parms_id), want.scale, want.is_ntt_form), name
    back = ev.transform_from_ntt(a)
    assert ev.transform_to_ntt_inplace(back) is back and back.is_ntt_form
    np.testing.assert_array_equal(back.to_numpy(), a.to_numpy())
    same = a.copy()
    assert ev.mod_switch_to_inplace(same, a.parms_id) is same and same.data is a.data


def test_transparency_flag_default_is_seal_tpu():
    assert config.throw_on_transparent_ciphertext is seal_tpu_config.throw_on_transparent_ciphertext


# -- (c) SEAL's vectors ------------------------------------------------------------------

def test_seal_vectors_ckks_multiply_many_rescale_to_add_many():
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(st.CoeffModulus.create(64, [40, 40, 40, 40]))
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    rk = interop.relin_keys_from_numpy(ctx, [np.stack([
        np.stack([ref(VC, f"relin_key_{i}_c{c}", 4) for c in range(2)]) for i in range(3)])])
    scale = 2.0 ** VC["scale_log2"]
    ct1, ct2 = (interop.ciphertext_from_numpy(
        ctx, np.stack([ref(VC, f"{name}_c{j}", 3) for j in range(2)]), ctx.first_parms_id,
        scale) for name in ("ct1", "ct2"))
    ev = st.Evaluator(ctx)
    relin = ev.multiply_many([ct1, ct2], rk)
    assert_ct(VC, "relin", relin)
    assert_ct(VC, "add", ev.add_many([ct1, ct2]))
    out = ev.rescale_to(relin, ctx.first_context_data().next_context_data.parms_id)
    assert_ct(VC, "rescale", out)
    assert out.scale == VC["rescale_scale"]
    assert ev.rescale_to(relin, relin.parms_id) is relin


def test_seal_vectors_bfv_multiply_many_and_add_many():
    ctx = port_context(st.SchemeType.BFV, 64, [40, 40, 40], 257)
    rk = interop.relin_keys_from_numpy(ctx, [np.stack([
        np.stack([ref(V, f"relin0_{i}_c{c}", 3) for c in range(2)]) for i in range(2)])])
    ct1, ct2 = (interop.ciphertext_from_numpy(
        ctx, np.stack([ref(V, f"{name}_c{j}", 2) for j in range(2)]), ctx.first_parms_id, 1.0,
        is_ntt_form=False) for name in ("ct1", "ct2"))
    ev = st.Evaluator(ctx)
    assert_ct(V, "ct_relin", ev.multiply_many([ct1, ct2], rk))
    assert_ct(V, "ct_add", ev.add_many([ct1, ct2]))
    ms = ev.mod_switch_to(ev.relinearize(ev.multiply(ct1, ct2), rk),
                          ctx.first_context_data().next_context_data.parms_id)
    assert_ct(V, "ct_modswitch", ms)


# -- (d) hoisted rotations of coefficient-form ciphertexts ---------------------------------

SMALL_STEPS = [1, 2, 5]
LOOP_STEPS = list(range(1, 18))          # 17 live steps: seal_tpu's lax.scan branch


def test_bfv_hoisted_matches_seal_tpu_jit():
    """The port's coefficient branches against seal_tpu's, under one jit of
    both calls; keys and the ciphertext from one seed in each library."""
    ctx = port_context(st.SchemeType.BFV, 64, [40, 40, 40], 257, seed=SEED)
    sctx = _seal_tpu_context("BFV", 64, [40, 40, 40], 257)
    kg, skg = st.KeyGenerator(ctx), seal_tpu.KeyGenerator(sctx)
    gk, sgk = kg.create_galois_keys(steps=LOOP_STEPS), skg.create_galois_keys(steps=LOOP_STEPS)
    values = list(range(64))
    ct = st.Encryptor(ctx, kg.create_public_key()).encrypt(st.BatchEncoder(ctx).encode(values))
    sct = seal_tpu.Encryptor(sctx, skg.create_public_key()).encrypt(
        seal_tpu.BatchEncoder(sctx).encode(values))
    np.testing.assert_array_equal(ct.to_numpy(), sct.to_numpy())
    sev, ev = seal_tpu.Evaluator(sctx), st.Evaluator(ctx)

    def rotations(data):
        c = sct.copy()
        c.data = data
        return [[o.data for o in sev.rotate_batch_hoisted(c, steps, sgk)]
                for steps in (SMALL_STEPS, LOOP_STEPS)]

    want = jax.jit(rotations)(sct.data)
    for steps, theirs in zip((SMALL_STEPS, LOOP_STEPS), want):
        got = ev.rotate_batch_hoisted(ct, steps, gk)
        for s, g, (lo, hi) in zip(steps, got, theirs):
            w = np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << 32)
            np.testing.assert_array_equal(g.to_numpy(), w, err_msg=f"step {s}")


@pytest.mark.parametrize("scheme", ["BFV", "BGV"])
def test_hoisted_decrypts_as_rotate_rows(scheme):
    ctx = port_context(st.SchemeType[scheme], 64, [40, 40, 40], 257, seed=SEED)
    kg = st.KeyGenerator(ctx)
    gk = kg.create_galois_keys(steps=LOOP_STEPS)
    be, ev = st.BatchEncoder(ctx), st.Evaluator(ctx)
    dec = st.Decryptor(ctx, kg.secret_key())
    ct = st.Encryptor(ctx, kg.create_public_key()).encrypt(be.encode(list(range(64))))
    for steps in (SMALL_STEPS + [0], LOOP_STEPS):
        for s, out in zip(steps, ev.rotate_batch_hoisted(ct, steps, gk)):
            want = be.decode(dec.decrypt(ct if s == 0 else ev.rotate_rows(ct, s, gk)))
            np.testing.assert_array_equal(be.decode(dec.decrypt(out)).numpy(), want.numpy(),
                                          err_msg=f"{scheme} step {s}")
