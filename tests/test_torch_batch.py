"""Batches through the port's Evaluator on the CPU, bit for bit (tolerance 0).

A batch of ciphertexts [B, size, L, N] shares its metadata, as bench.py's
jax.vmap shares ct1's. Every op on a batch must give, member for member,
the bits and metadata of the same op on that member alone:
(a) at n = 1024 and B = 3, for CKKS, BFV and BGV at α = 1 and 2, every op
    of the Evaluator, with config.keyswitch_shoup off and, for the ops that
    switch keys, on; plaintext operands shared by the batch or batched;
(b) K2/K3's plain versions over [B, J, I, N] (and two batch dimensions)
    against a loop of unbatched calls;
(c) config.throw_on_transparent_ciphertext both ways, and the refusals of
    shapes that do not match;
(d) the α = 2 fused pipeline at B = 2 against jax.jit(jax.vmap(one)) of
    seal_tpu, with `one` as bench.py:161-167 builds it (one compile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seal_tpu
import seal_tpu_torch as st
from seal_tpu_torch.config import config
from seal_tpu_torch.dtypes import Ciphertext, stack_ciphertexts
from seal_tpu_torch.ops import keyswitch
from tests.test_torch_evaluator import seeded_state_matches_seal_tpu

N = 1024
B = 3
SCALE = 2.0 ** 30
ROT_STEPS = [1, 2, 4]
SCAN_STEPS = list(range(1, 18))      # 17 live steps: the hoisted loop branch
CONFIGS = {
    "CKKS-a1": (st.SchemeType.CKKS, 1, [40] * 4 + [50]),
    "CKKS-a2": (st.SchemeType.CKKS, 2, [40] * 4 + [45] * 2),
    "BFV-a1": (st.SchemeType.BFV, 1, [50] * 4 + [60]),
    "BFV-a2": (st.SchemeType.BFV, 2, [50] * 4 + [55] * 2),
    "BGV-a1": (st.SchemeType.BGV, 1, [50] * 4 + [60]),
    "BGV-a2": (st.SchemeType.BGV, 2, [50] * 4 + [55] * 2),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the suite's other worker processes, a
    thread per core waits at every op's barrier for threads that are not
    running (tests/test_torch_keys_seeded.py does the same)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _context(scheme, alpha, bits):
    parms = st.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(st.CoeffModulus.create(N, bits))
    if scheme != st.SchemeType.CKKS:
        parms.set_plain_modulus(st.PlainModulus.batching(N, 20))
    parms.set_special_modulus_size(alpha)
    parms.set_random_seed((int(scheme), alpha) * 4)
    return st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")


@pytest.fixture(scope="module", params=list(CONFIGS))
def state(request):
    """Keys, B public-key and B symmetric encryptions, and plaintexts: one
    shared, one batched."""
    scheme, alpha, bits = CONFIGS[request.param]
    ctx = _context(scheme, alpha, bits)
    kg = st.KeyGenerator(ctx)
    rk, gk = kg.create_relin_keys(2), kg.create_galois_keys(steps=SCAN_STEPS + [0])
    enc = st.Encryptor(ctx, kg.create_public_key(), kg.secret_key())
    rng = np.random.default_rng(int(scheme) * 10 + alpha)
    if scheme == st.SchemeType.CKKS:
        encoder = st.CKKSEncoder(ctx)
        plains = encoder.encode_many(rng.uniform(-1, 1, (B + 1, N // 2)), SCALE)
    else:
        t = ctx.key_context_data().parms.plain_modulus.value
        plains = st.BatchEncoder(ctx).encode_many(rng.integers(0, t, (B + 1, N)))
    a, b = enc.encrypt_many(plains[:B]), enc.encrypt_symmetric_many(plains[1:])
    plain_batch = st.Plaintext(torch.stack([p.data for p in plains[:B]]), plains[0].parms_id,
                               plains[0].scale)
    return dict(name=request.param, scheme=scheme, ctx=ctx, ev=st.Evaluator(ctx), rk=rk,
                gk=gk, a=a, b=b, plain=plains[B], plain_batch=plain_batch)


def _ops(s):
    """{name: (op(a, b) -> Ciphertext or list, switches keys)} for the
    state's scheme; a and b are two ciphertexts (or batches) of size 2."""
    ev, rk, gk, p = s["ev"], s["rk"], s["gk"], s["plain"]
    ckks = s["scheme"] == st.SchemeType.CKKS
    elt = s["ctx"].first_context_data().galois_tool.get_elt_from_step(1)
    last = s["ctx"].last_parms_id
    ops = {
        "add": (lambda a, b: ev.add(a, b), False),
        "sub": (lambda a, b: ev.sub(a, b), False),
        "negate": (lambda a, b: ev.negate(a), False),
        "sub_sizes_3_2": (lambda a, b: ev.sub(ev.multiply(a, b), ev.multiply_plain(b, p)),
                          False),
        "multiply": (lambda a, b: ev.multiply(a, b), False),
        "multiply_size_3_2": (lambda a, b: ev.multiply(ev.multiply(a, b), a), False),
        "square": (lambda a, b: ev.square(a), False),
        "relinearize": (lambda a, b: ev.relinearize(ev.multiply(a, b), rk), True),
        "relinearize_size_4": (
            lambda a, b: ev.relinearize(ev.multiply(ev.multiply(a, b), a), rk), True),
        "mod_switch_to_next": (lambda a, b: ev.mod_switch_to_next(ev.multiply(a, b)), False),
        "mod_switch_to": (lambda a, b: ev.mod_switch_to(a, last), False),
        "add_plain": (lambda a, b: ev.add_plain(a, p), False),
        "sub_plain": (lambda a, b: ev.sub_plain(a, p), False),
        "multiply_plain": (lambda a, b: ev.multiply_plain(a, p), False),
        "apply_galois": (lambda a, b: ev.apply_galois(a, elt, gk), True),
        "hoisted": (lambda a, b: ev.rotate_batch_hoisted(a, ROT_STEPS, gk), True),
        "hoisted_loop": (lambda a, b: ev.rotate_batch_hoisted(a, SCAN_STEPS, gk), True),
    }
    if ckks:
        ops.update({
            "relinearize_rescale": (
                lambda a, b: ev.relinearize_rescale(ev.multiply(a, b), rk), True),
            "relinearize_rescale_size_4": (lambda a, b: ev.relinearize_rescale(
                ev.multiply(ev.multiply(a, b), a), rk), True),
            "rescale_to_next": (
                lambda a, b: ev.rescale_to_next(ev.relinearize(ev.multiply(a, b), rk)), True),
            "rotate_vector": (lambda a, b: ev.rotate_vector(a, 1, gk), True),
            "rotate_vector_naf": (lambda a, b: ev.rotate_vector(a, 18, gk), True),
            "complex_conjugate": (lambda a, b: ev.complex_conjugate(a, gk), True),
        })
    else:
        ntt_plain = ev.transform_plain_to_ntt(p, s["ctx"].first_parms_id)
        ops.update({
            "rotate_rows": (lambda a, b: ev.rotate_rows(a, 1, gk), True),
            "rotate_rows_naf": (lambda a, b: ev.rotate_rows(a, 18, gk), True),
            "rotate_columns": (lambda a, b: ev.rotate_columns(a, gk), True),
            "relin_mod_switch_rotate": (lambda a, b: ev.rotate_rows(ev.mod_switch_to_next(
                ev.relinearize(ev.multiply(a, b), rk)), 2, gk), True),
            "add_plain_level_1": (lambda a, b: ev.add_plain(ev.mod_switch_to_next(a), p),
                                  False),
            "multiply_plain_ntt": (lambda a, b: ev.transform_from_ntt(
                ev.multiply_plain(ev.transform_to_ntt(a), ntt_plain)), False),
            "add_correction_factors": (lambda a, b: ev.add(
                ev.square(ev.mod_switch_to_next(a)), ev.mod_switch_to_next(b)), False),
        })
    return ops


def _members(out):
    return out if isinstance(out, list) else [out]


def _assert_member(got: Ciphertext, b: int, want: Ciphertext, what):
    assert got.batch_shape == (B,), what
    assert torch.equal(got.data[b], want.data), what
    assert (tuple(got.parms_id), got.is_ntt_form, got.scale, got.correction_factor) == \
        (tuple(want.parms_id), want.is_ntt_form, want.scale, want.correction_factor), what


def _batch_equals_sequential(s, name):
    op, switches_keys = _ops(s)[name]
    x, y = stack_ciphertexts(s["a"]), stack_ciphertexts(s["b"])
    for shoup in (False, True) if switches_keys else (False,):
        config.keyswitch_shoup = shoup
        try:
            got = _members(op(x, y))
            for b in range(B):
                want = _members(op(s["a"][b], s["b"][b]))
                for g, w in zip(got, want, strict=True):
                    _assert_member(g, b, w, (s["name"], name, shoup, b))
        finally:
            config.keyswitch_shoup = False


_COMMON = ["add", "sub", "negate", "sub_sizes_3_2", "multiply", "multiply_size_3_2", "square",
           "relinearize", "relinearize_size_4", "mod_switch_to_next", "mod_switch_to",
           "add_plain", "sub_plain", "multiply_plain", "apply_galois", "hoisted",
           "hoisted_loop"]
_CKKS = ["relinearize_rescale", "relinearize_rescale_size_4", "rescale_to_next",
         "rotate_vector", "rotate_vector_naf", "complex_conjugate"]
_EXACT = ["rotate_rows", "rotate_rows_naf", "rotate_columns", "relin_mod_switch_rotate",
          "add_plain_level_1", "multiply_plain_ntt", "add_correction_factors"]


@pytest.mark.parametrize("name", _COMMON + _CKKS + _EXACT)
def test_batch_equals_sequential(state, name):
    ops = _ops(state)
    if name not in ops:
        assert name in (_EXACT if state["scheme"] == st.SchemeType.CKKS else _CKKS)
        return
    _batch_equals_sequential(state, name)


@pytest.mark.parametrize("op", ["add_plain", "sub_plain", "multiply_plain"])
def test_batched_plaintext_operand(state, op):
    """A batch of plaintexts meets the batch member for member."""
    fn = getattr(state["ev"], op)
    got = fn(stack_ciphertexts(state["a"]), state["plain_batch"])
    plains = [st.Plaintext(d, state["plain_batch"].parms_id, state["plain_batch"].scale)
              for d in state["plain_batch"].data.unbind(0)]
    for b in range(B):
        _assert_member(got, b, fn(state["a"][b], plains[b]), (state["name"], op, b))


def test_batch_refusals(state):
    """Mismatched batch shapes, a plaintext batch of another size, and the
    calls that take one ciphertext or plaintext only are refused with a
    clear error."""
    ev, x = state["ev"], stack_ciphertexts(state["a"])
    with pytest.raises(ValueError, match="batch shapes"):
        ev.add(x, state["a"][0])
    short = st.Plaintext(state["plain_batch"].data[:2], state["plain_batch"].parms_id,
                         state["plain_batch"].scale)
    with pytest.raises(ValueError, match="plain batch"):
        ev.add_plain(x, short)
    sk = st.KeyGenerator(state["ctx"]).secret_key()
    with pytest.raises(ValueError, match="as a list"):
        st.Encryptor(state["ctx"], sk).encrypt_symmetric(state["plain_batch"])
    if state["scheme"] != st.SchemeType.CKKS:
        with pytest.raises(ValueError, match="decode_many"):
            st.BatchEncoder(state["ctx"]).decode(state["plain_batch"])
        with pytest.raises(ValueError, match="decrypt_many"):
            st.Decryptor(state["ctx"], sk).decrypt(x)
        with pytest.raises(ValueError, match="not a batch"):
            st.Decryptor(state["ctx"], sk).invariant_noise_budget(x)


# -- (b) the plain key-switch products over a batch ------------------------------

@pytest.mark.parametrize("lead", [(1,), (3,), (2, 3)])
@pytest.mark.parametrize("J,I", [(1, 3), (4, 5)])
def test_plain_keyswitch_batch_matches_loop(lead, J, I):
    """keyswitch_inner_plain and keyswitch_inner_shoup_plain over t [*lead,
    J, I, N] and one key: each member equals the unbatched call."""
    n = 64
    moduli = [m.value for m in st.CoeffModulus.create(1024, [54] * I)]
    q = np.array(moduli, dtype=np.int64)[:, None]
    rng = np.random.default_rng(J * 10 + len(lead))
    t = torch.from_numpy(rng.integers(0, q, lead + (J, I, n), dtype=np.int64))
    k = torch.from_numpy(rng.integers(0, q, (J, 2, I, n), dtype=np.int64))
    kq = keyswitch.key_quotients(k, moduli)
    consts = keyswitch.pack_mod_consts(moduli, "cpu")
    k2 = keyswitch.keyswitch_inner(t, k, consts)
    k3 = keyswitch.keyswitch_inner_shoup(t, k, kq, consts, max(moduli))
    assert k2.shape == lead + (2, I, n)
    flat_t, flat_2, flat_3 = (a.reshape((-1,) + a.shape[len(lead):]) for a in (t, k2, k3))
    for b in range(flat_t.shape[0]):
        assert torch.equal(flat_2[b], keyswitch.keyswitch_inner_plain(flat_t[b], k, consts))
        assert torch.equal(flat_3[b], keyswitch.keyswitch_inner_shoup_plain(
            flat_t[b], k, kq, consts, max(moduli)))
    assert torch.equal(k2, k3)


# -- (c) the transparency flag -------------------------------------------------------

def test_throw_on_transparent_ciphertext_both_ways(monkeypatch):
    """On (the default): relinearize refuses a batch when any member is
    transparent, as seal_tpu refuses one ciphertext (tests/
    test_evaluator_reference.py TestTransparentGuard). Off: the op never
    reads the device for it, and the transparent member decrypts to 0."""
    scheme, alpha, bits = CONFIGS["BFV-a1"]
    ctx = _context(scheme, alpha, bits)
    kg = st.KeyGenerator(ctx)
    rk = kg.create_relin_keys()
    enc, ev = st.Encryptor(ctx, kg.create_public_key()), st.Evaluator(ctx)
    cts = enc.encrypt_many([st.Plaintext(torch.tensor([5 + b])) for b in range(2)])
    squares = [ev.multiply(ct, ct) for ct in cts]
    zero = ev.sub(squares[0], squares[0])
    mixed = stack_ciphertexts([squares[1], zero])
    assert config.throw_on_transparent_ciphertext
    assert mixed.is_transparent() and not stack_ciphertexts(squares).is_transparent()
    for batch in (zero, mixed):
        with pytest.raises(ValueError, match="transparent"):
            ev.relinearize(batch, rk)
    ev.relinearize(stack_ciphertexts(squares), rk)

    def unread(self):
        raise AssertionError("is_transparent read with the flag off")

    monkeypatch.setattr(config, "throw_on_transparent_ciphertext", False)
    monkeypatch.setattr(Ciphertext, "is_transparent", unread)
    out = ev.relinearize(mixed, rk)
    dec = st.Decryptor(ctx, kg.secret_key()).decrypt_many(out.unbind())
    assert [p.to_hex_string() for p in dec] == ["24", "0"]


# -- (d) seal_tpu's vmap ----------------------------------------------------------------

def _u64(pair) -> np.ndarray:
    lo, hi = (np.asarray(x).astype(np.uint64) for x in pair)
    return lo | (hi << np.uint64(32))


def test_fused_pipeline_batch_matches_seal_tpu_vmap():
    """bench.py's α = 2 pipeline (multiply -> relinearize_rescale) as
    jax.jit(jax.vmap(one)) of seal_tpu over B = 2 pairs of different
    ciphertexts, the relinearization key closed over; the port runs the
    same stacked batch, and every word and the metadata must agree."""
    seed = (6, 1, 2, 3, 4, 5, 6, 2)
    bits = [40] * 6
    sp = seal_tpu.EncryptionParameters(seal_tpu.SchemeType.CKKS)
    sp.set_poly_modulus_degree(N)
    sp.set_coeff_modulus(seal_tpu.CoeffModulus.create(N, bits))
    sp.set_special_modulus_size(2)
    sp.set_random_seed(seed)
    sctx = seal_tpu.SEALContext(sp, sec_level=seal_tpu.SecLevelType.NONE)
    parms = st.EncryptionParameters(st.SchemeType.CKKS)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(st.CoeffModulus.create(N, bits))
    parms.set_special_modulus_size(2)
    parms.set_random_seed(seed)
    ctx = st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")
    rng = np.random.default_rng(62)
    values = [rng.uniform(-1, 1, N // 2) for _ in range(2)]
    (srk, _, (sct1, sct2)), (rk, _, (ct1, ct2)) = seeded_state_matches_seal_tpu(
        sctx, ctx, values, 2.0 ** 30)
    sev = seal_tpu.Evaluator(sctx)

    def one(x_pair, y_pair):
        ca = sct1.copy()
        ca.data = x_pair
        cb = sct2.copy()
        cb.data = y_pair
        return sev.relinearize_rescale(sev.multiply(ca, cb), srk).data

    def stacked(first, second):
        return tuple(jnp.stack([u, v]) for u, v in zip(first.data, second.data))

    want = _u64(jax.jit(jax.vmap(one))(stacked(sct1, sct2), stacked(sct2, sct1)))
    ev = st.Evaluator(ctx)
    got = ev.relinearize_rescale(ev.multiply(stack_ciphertexts([ct1, ct2]),
                                             stack_ciphertexts([ct2, ct1])), rk)
    np.testing.assert_array_equal(got.to_numpy(), want)
    assert got.scale == ct1.scale * ct2.scale / ctx.first_context_data().key_moduli()[-1]
    assert tuple(got.parms_id) == tuple(ctx.first_context_data().next_context_data.parms_id)
