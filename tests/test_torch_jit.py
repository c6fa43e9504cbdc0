"""jit.JitEvaluator and jit.capture against the eager Evaluator, bit for bit.

On a CPU context the cache path runs each op eagerly on the static input
buffers of its cache entry, where the card replays a CUDA graph: so every
case here calls an op twice under one cache key, on two different inputs,
and holds the second call (the one that goes through the buffers, the
recorded output metadata and the key objects the entry was made with)
against the eager Evaluator. CKKS at α = 1 and 2, BFV and BGV, at n = 256.
The `cuda`-marked tests at the end run the same checks on the card, where
the entries are CUDA graphs; they skip without one.

No test here runs seal_tpu: the port's eager path is held against it
elsewhere.
"""

import numpy as np
import pytest
import torch

import seal_tpu_torch as st
from seal_tpu_torch import cuda, jit
from seal_tpu_torch.config import config
from seal_tpu_torch.dtypes import stack_ciphertexts

N = 256
STEPS = [1, 2, 4, 8, -1, -2, -4, -8, 0]     # rotation keys; 3 goes by NAF (4 - 1)
SCHEMES = {
    "ckks_a1": (st.SchemeType.CKKS, [40] * 4, 1),
    "ckks_a2": (st.SchemeType.CKKS, [40] * 6, 2),
    "bfv": (st.SchemeType.BFV, [40] * 4, 1),
    "bgv": (st.SchemeType.BGV, [40] * 6, 2),
}


class State:
    """A context with keys, an evaluator and fresh ciphertexts."""

    def __init__(self, name, device="cpu", n=N, seed=1):
        scheme, bits, alpha = SCHEMES[name]
        self.scheme = scheme
        self.ctx = _context(scheme, bits, alpha, n, device, seed)
        kg = st.KeyGenerator(self.ctx)
        self.rk = kg.create_relin_keys()
        self.gk = kg.create_galois_keys(steps=STEPS)
        self.enc = st.Encryptor(self.ctx, kg.create_public_key())
        self.ev = st.Evaluator(self.ctx)
        self.rng = np.random.default_rng(seed)
        if scheme == st.SchemeType.CKKS:
            self.encoder = st.CKKSEncoder(self.ctx)
        else:
            self.encoder = st.BatchEncoder(self.ctx)
        self.other_ctx = (scheme, bits, alpha, n, device)

    def plain(self):
        if self.scheme == st.SchemeType.CKKS:
            return self.encoder.encode(self.rng.uniform(-1, 1, self.encoder.slot_count),
                                       2.0 ** 30)
        t = self.ctx.first_context_data().parms.plain_modulus.value
        return self.encoder.encode(self.rng.integers(0, t, self.encoder.slot_count))

    def ct(self):
        return self.enc.encrypt(self.plain())

    def second_relin_keys(self):
        """Relinearization keys of the same shapes under another secret."""
        return st.KeyGenerator(_context(*self.other_ctx, seed=99)).create_relin_keys()


def _context(scheme, bits, alpha, n, device, seed):
    parms = st.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
    parms.set_special_modulus_size(alpha)
    if scheme != st.SchemeType.CKKS:
        parms.set_plain_modulus(st.PlainModulus.batching(n, 20))
    parms.set_random_seed((seed, 2, 3, 4, 5, 6, 7, 8))
    return st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device=device)


@pytest.fixture(scope="module")
def states():
    """State by scheme name, each made once for the module."""
    torch.set_num_threads(1)
    made = {}

    def get(name):
        if name not in made:
            made[name] = State(name)
        return made[name]

    return get


def assert_same(got, want):
    """Ciphertexts (or lists of them) equal in bits and metadata."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
        return
    assert torch.equal(got.data, want.data)
    assert (tuple(got.parms_id), got.is_ntt_form, got.scale, got.correction_factor) == \
        (tuple(want.parms_id), want.is_ntt_form, want.scale, want.correction_factor)


def _inplace(e, a, b, s):
    a = a.copy()
    out = e.multiply_inplace(a, b)
    assert out is a
    return a


# op name -> (schemes it runs in, the call on an evaluator e, inputs a, b, state s)
OPS = {
    "multiply": (None, lambda e, a, b, s: e.multiply(a, b)),
    "square": (None, lambda e, a, b, s: e.square(a)),
    "relinearize": (None, lambda e, a, b, s: e.relinearize(s.ev.multiply(a, b), s.rk)),
    "relinearize_rescale": ("ckks", lambda e, a, b, s: e.relinearize_rescale(
        s.ev.multiply(a, b), s.rk)),
    "rescale_to_next": ("ckks", lambda e, a, b, s: e.rescale_to_next(s.ev.multiply(a, b))),
    "mod_switch_to_next": (None, lambda e, a, b, s: e.mod_switch_to_next(a)),
    "rotate_vector_naf": ("ckks", lambda e, a, b, s: e.rotate_vector(a, 3, s.gk)),
    "complex_conjugate": ("ckks", lambda e, a, b, s: e.complex_conjugate(a, s.gk)),
    "rotate_rows_naf": ("exact", lambda e, a, b, s: e.rotate_rows(a, 3, s.gk)),
    "rotate_columns": ("exact", lambda e, a, b, s: e.rotate_columns(a, s.gk)),
    "rotate_batch_hoisted": (None, lambda e, a, b, s: e.rotate_batch_hoisted(
        a, [1, 0, -2, 8], s.gk)),
    "add_many": (None, lambda e, a, b, s: e.add_many([a, b, a])),
    "multiply_inplace": (None, _inplace),
    "plain_passes_through": (None, lambda e, a, b, s: e.multiply_plain(a, s.fixed_plain)),
}


def ops_of(name):
    kinds = (None, "ckks") if name.startswith("ckks") else (None, "exact")
    return [op for op, (kind, _) in sorted(OPS.items()) if kind in kinds]


@pytest.mark.parametrize("name,op", [(name, op) for name in sorted(SCHEMES)
                                     for op in ops_of(name)])
def test_jit_equals_eager(states, name, op):
    state = states(name)
    call = OPS[op][1]
    if op == "plain_passes_through":
        state.fixed_plain = state.plain()
    jev = jit.JitEvaluator(state.ctx)
    for _ in range(2):
        a, b = state.ct(), state.ct()
        assert_same(call(jev, a, b, state), call(state.ev, a, b, state))
    # the second call hit the first call's entry; a plaintext op makes none
    assert jev.cache_size() == (0 if op == "plain_passes_through" else 1)


def test_cache_rule():
    """The same shapes and metadata add no entry; another level, another
    size or the other key-switch route adds one."""
    s = State("ckks_a2")
    jev = jit.JitEvaluator(s.ctx)
    a, b = s.ct(), s.ct()
    jev.multiply(a, b)
    jev.multiply(s.ct(), s.ct())
    assert jev.cache_size() == 1
    jev.multiply(s.ev.mod_switch_to_next(a), s.ev.mod_switch_to_next(b))
    assert jev.cache_size() == 2
    jev.multiply(s.ev.multiply(a, b), b)
    assert jev.cache_size() == 3
    prod = s.ev.multiply(a, b)
    jev.relinearize(prod, s.rk)
    config.keyswitch_shoup = True
    try:
        assert_same(jev.relinearize(prod, s.rk), s.ev.relinearize(prod, s.rk))
    finally:
        config.keyswitch_shoup = False
    assert jev.cache_size() == 5
    jev.clear_cache()
    assert jev.cache_size() == 0


def test_two_keys_of_the_same_shapes():
    """A second relinearization key of the same shapes is never served the
    first key's entry: each gives its own eager result."""
    s = State("ckks_a2")
    rk2 = s.second_relin_keys()
    assert [k.shape for k in rk2.keys] == [k.shape for k in s.rk.keys]
    jev = jit.JitEvaluator(s.ctx)
    for _ in range(2):
        prod = s.ev.multiply(s.ct(), s.ct())
        want1, want2 = s.ev.relinearize(prod, s.rk), s.ev.relinearize(prod, rk2)
        assert not torch.equal(want1.data, want2.data)
        assert_same(jev.relinearize(prod, s.rk), want1)
        assert_same(jev.relinearize(prod, rk2), want2)
    assert jev.cache_size() == 2


def hoisted_step_sets_alternate(s):
    """Hoisted rotations by two step sets in turns under one Galois key: one
    entry per step set, though each call may fill the key's permuted-key
    cache with another element."""
    jev = jit.JitEvaluator(s.ctx)
    for steps in ([1], [2], [1], [2], [1]):
        a = s.ct()
        assert_same(jev.rotate_batch_hoisted(a, steps, s.gk),
                    s.ev.rotate_batch_hoisted(a, steps, s.gk))
    assert jev.cache_size() == 2


def test_hoisted_step_sets_alternate():
    hoisted_step_sets_alternate(State("ckks_a2"))


def test_batch():
    """Stacked ciphertexts [B, 2, L, N] through the JitEvaluator."""
    s = State("ckks_a1")
    jev = jit.JitEvaluator(s.ctx)
    for _ in range(2):
        x = stack_ciphertexts([s.ct() for _ in range(3)])
        y = stack_ciphertexts([s.ct() for _ in range(3)])
        assert_same(jev.rescale_to_next(jev.relinearize(jev.multiply(x, y), s.rk)),
                    s.ev.rescale_to_next(s.ev.relinearize(s.ev.multiply(x, y), s.rk)))
    assert jev.cache_size() == 3


def bench_one(s, fused):
    """bench.py's `one` over data tensors [B, 2, L, N] (its jax.vmap is the
    batch axis), against the state's first ciphertexts' metadata."""
    proto = s.ct()

    def one(x, y):
        ca, cb = proto.copy(), proto.copy()
        ca.data, cb.data = x, y
        if fused:
            return s.ev.relinearize_rescale(s.ev.multiply(ca, cb), s.rk).data
        return s.ev.rescale_to_next(s.ev.relinearize(s.ev.multiply(ca, cb), s.rk)).data

    return one


@pytest.mark.parametrize("name", ["ckks_a1", "ckks_a2"])
def test_capture_of_bench_one(name):
    s = State(name)
    one = bench_one(s, fused=name == "ckks_a2")
    step = jit.capture(one)
    for _ in range(2):
        x = torch.stack([s.ct().data for _ in range(4)])
        y = torch.stack([s.ct().data for _ in range(4)])
        assert torch.equal(step(x, y), one(x, y))
    assert step.cache_size() == 1


def test_capture_refuses_what_cannot_key_it():
    s = State("ckks_a1")
    step = jit.capture(lambda ct, extra: s.ev.multiply(ct, ct))
    with pytest.raises(TypeError, match="plaintext"):
        step(s.ct(), s.plain())
    with pytest.raises(TypeError):
        step(s.ct(), {"not": "hashable"})


# --- the same on the card, where the entries are CUDA graphs -----------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_graphs_equal_eager_on_card(card, name):
    """Every op of test_jit_equals_eager replayed from a CUDA graph, with
    the launches per replay equal to the eager call's."""
    s = State(name, device="cuda", n=1024)
    s.fixed_plain = s.plain()
    for op in ops_of(name):
        call = OPS[op][1]
        jev = jit.JitEvaluator(s.ctx)
        for _ in range(3):
            a, b = s.ct(), s.ct()
            cuda.reset_launches()
            want = call(s.ev, a, b, s)
            torch.cuda.synchronize()
            eager = dict(cuda.launches)
            cuda.reset_launches()
            got = call(jev, a, b, s)
            torch.cuda.synchronize()
            assert_same(got, want)
            assert dict(cuda.launches) == eager, op


@pytest.mark.cuda
def test_hoisted_step_sets_alternate_on_card(card):
    hoisted_step_sets_alternate(State("ckks_a2", device="cuda", n=1024))


@pytest.mark.cuda
def test_two_keys_on_card(card):
    s = State("ckks_a2", device="cuda", n=1024)
    rk2 = s.second_relin_keys()
    jev = jit.JitEvaluator(s.ctx)
    for _ in range(3):
        prod = s.ev.multiply(s.ct(), s.ct())
        assert_same(jev.relinearize(prod, s.rk), s.ev.relinearize(prod, s.rk))
        assert_same(jev.relinearize(prod, rk2), s.ev.relinearize(prod, rk2))
    assert jev.cache_size() == 2 and jev.pool_bytes() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ckks_a1", "ckks_a2"])
def test_capture_of_bench_one_on_card(card, name):
    s = State(name, device="cuda", n=1024)
    one = bench_one(s, fused=name == "ckks_a2")
    step = jit.capture(one)
    for _ in range(3):
        x = torch.stack([s.ct().data for _ in range(16)])
        y = torch.stack([s.ct().data for _ in range(16)])
        assert torch.equal(step(x, y), one(x, y))
    assert step.cache_size() == 1
