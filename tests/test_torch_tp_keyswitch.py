"""parallel/keyswitch.py: the key switch split over tp gloo ranks on the CPU,
bit for bit the port's unsharded Evaluator, with ONE all_reduce per key
switch and per hoisted rotation batch; and one TP relinearize and one
hoisted batch at n = 64 against seal_tpu's TPEvaluator on the 8 virtual
CPU devices, the inputs carried across with seal_tpu_torch.interop.

Each group of ranks runs every case of its world size in one spawn (a
module-scoped fixture) under its own time limit; the tests read the cases'
records. seal_tpu and JAX are imported only in the parent process, inside
the test that needs them.
"""

import numpy as np
import pytest
import torch

import seal_tpu_torch as st
from seal_tpu_torch.parallel import launch

SEED = (1, 2, 3, 4, 5, 6, 7, 8)
N = 64
LIMIT_S = 120
HOISTED = [1, 2, -1, 0]
HOISTED_17 = list(range(1, 18))          # more than 16 steps: the other branch


def _context(scheme, bits, alpha=1, n=N):
    parms = st.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(st.CoeffModulus.create(n, bits))
    if scheme != st.SchemeType.CKKS:
        parms.set_plain_modulus(257)
    parms.set_special_modulus_size(alpha)
    parms.set_random_seed(SEED)
    return st.SEALContext(parms, sec_level=st.SecLevelType.NONE, device="cpu")


def _same(a, b) -> bool:
    return (tuple(a.parms_id) == tuple(b.parms_id) and a.scale == b.scale
            and torch.equal(a.data, b.data))


def _case(cases, name, hm, fn):
    """cases[name] = (fn()'s verdict, the census of that call)."""
    hm.census.reset()
    ok = fn()
    cases[name] = (bool(ok), hm.census.snapshot())


def _tp_cases(rank):
    from seal_tpu_torch.config import config
    from seal_tpu_torch.parallel import HEMesh, TPEvaluator, tp_relinearize
    from seal_tpu_torch.parallel.keyswitch import TPKeySwitch

    hm = HEMesh(1, rank.world, device="cpu")
    cases = {}
    rng = np.random.default_rng(rank.world)

    def ckks(bits, alpha):
        ctx = _context(st.SchemeType.CKKS, bits, alpha)
        kg = st.KeyGenerator(ctx)
        enc = st.Encryptor(ctx, kg.create_public_key())
        encoder = st.CKKSEncoder(ctx)
        cts = [enc.encrypt(encoder.encode(rng.uniform(-1, 1, N // 2), 2.0 ** 20))
               for _ in range(2)]
        return ctx, kg, cts

    for shoup in (False, True):
        config.keyswitch_shoup = shoup
        tag = "shoup" if shoup else "k2"
        try:
            # CKKS α = 1: relinearize, tp_relinearize, rotate, conjugate
            ctx, kg, (a, b) = ckks([40] * 5, 1)
            rk = kg.create_relin_keys()
            gt = ctx.key_context_data().galois_tool
            gk = kg.create_galois_keys(
                gt.get_elts_from_steps(HOISTED_17 + [-1]) + [gt.get_elt_from_step(0)])
            ev, tev = st.Evaluator(ctx), TPEvaluator(ctx, hm)
            m = ev.multiply(a, b)
            _case(cases, f"ckks_alpha1_relinearize/{tag}", hm,
                  lambda: _same(tev.relinearize(m, rk), ev.relinearize(m, rk)))
            _case(cases, f"ckks_alpha1_tp_relinearize/{tag}", hm,
                  lambda: _same(tp_relinearize(ev, m, rk, hm), ev.relinearize(m, rk)))
            x = ev.rescale_to_next(ev.relinearize(m, rk))
            _case(cases, f"ckks_alpha1_rotate/{tag}", hm,
                  lambda: _same(tev.rotate_vector(x, 3, gk), ev.rotate_vector(x, 3, gk)))
            _case(cases, f"ckks_alpha1_conjugate/{tag}", hm,
                  lambda: _same(tev.complex_conjugate(a, gk), ev.complex_conjugate(a, gk)))
            for level, ct in (("first", a), ("rescaled", x)):
                for steps in (HOISTED, HOISTED_17):
                    _case(cases, f"ckks_alpha1_hoisted_{len(steps)}_{level}/{tag}", hm,
                          lambda: all(_same(p, q) for p, q in zip(
                              tev.rotate_batch_hoisted(ct, steps, gk),
                              ev.rotate_batch_hoisted(ct, steps, gk))))
            batch = st.dtypes.stack_ciphertexts([m, ev.square(b)])
            _case(cases, f"ckks_alpha1_batch_relinearize/{tag}", hm,
                  lambda: _same(tev.relinearize(batch, rk), ev.relinearize(batch, rk)))
            # past tp·max q >= 2^63 the partials travel as two 32-bit words
            tks = TPKeySwitch(ev, m.parms_id, hm.tp_comm)
            tks.split = True
            _case(cases, f"ckks_alpha1_split32/{tag}", hm, lambda: torch.equal(
                tks.prod_rows(m.poly(2), rk.key(2)),
                ev._switch_key_prod(m, m.poly(2), rk.key(2))))

            # CKKS α = 2: hybrid relinearize and the fused relinearize_rescale
            ctx, kg, (a, b) = ckks([40] * 4 + [40, 40], 2)
            rk = kg.create_relin_keys()
            ev, tev = st.Evaluator(ctx), TPEvaluator(ctx, hm)
            m = ev.multiply(a, b)
            _case(cases, f"ckks_alpha2_relinearize/{tag}", hm,
                  lambda: _same(tev.relinearize(m, rk), ev.relinearize(m, rk)))
            _case(cases, f"ckks_alpha2_fused/{tag}", hm,
                  lambda: _same(tev.relinearize_rescale(m, rk), ev.relinearize_rescale(m, rk)))

            # every level of the chain, down to one data prime
            ctx, kg, (a, _) = ckks([40] * 6, 1)
            rk = kg.create_relin_keys()
            ev, tev = st.Evaluator(ctx), TPEvaluator(ctx, hm)
            for depth in range(1, 5):
                L = ctx.get_context_data(a.parms_id).coeff_modulus_size
                _case(cases, f"ckks_level_L{L}/{tag}", hm, lambda: _same(
                    tev.relinearize(ev.multiply(a, a), rk), ev.relinearize(ev.multiply(a, a), rk)))
                a = ev.rescale_to_next(ev.relinearize(ev.multiply(a, a), rk))

            # BFV and BGV: relinearize, rotate_rows, rotate_columns, hoisted
            for scheme in (st.SchemeType.BFV, st.SchemeType.BGV):
                name = scheme.name.lower()
                ctx = _context(scheme, [40, 40, 40])
                kg = st.KeyGenerator(ctx)
                rk = kg.create_relin_keys()
                gt = ctx.key_context_data().galois_tool
                gk = kg.create_galois_keys(
                    gt.get_elts_from_steps([1, -1]) + [gt.get_elt_from_step(0)])
                enc = st.Encryptor(ctx, kg.create_public_key())
                ct = enc.encrypt(st.BatchEncoder(ctx).encode(rng.integers(0, 257, N)))
                ev, tev = st.Evaluator(ctx), TPEvaluator(ctx, hm)
                m = ev.multiply(ct, ct)
                _case(cases, f"{name}_relinearize/{tag}", hm,
                      lambda: _same(tev.relinearize(m, rk), ev.relinearize(m, rk)))
                _case(cases, f"{name}_rotate_rows/{tag}", hm,
                      lambda: _same(tev.rotate_rows(ct, 1, gk), ev.rotate_rows(ct, 1, gk)))
                _case(cases, f"{name}_rotate_columns/{tag}", hm,
                      lambda: _same(tev.rotate_columns(ct, gk), ev.rotate_columns(ct, gk)))
                _case(cases, f"{name}_hoisted/{tag}", hm, lambda: all(_same(p, q) for p, q in zip(
                    tev.rotate_batch_hoisted(ct, [1, -1], gk),
                    ev.rotate_batch_hoisted(ct, [1, -1], gk))))
        finally:
            config.keyswitch_shoup = False
    return cases


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def cases(request):
    return request.param, launch.run(_tp_cases, request.param, "gloo", "cpu", LIMIT_S)


CASE_NAMES = [f"{c}/{tag}" for tag in ("k2", "shoup") for c in (
    "ckks_alpha1_relinearize", "ckks_alpha1_tp_relinearize", "ckks_alpha1_rotate",
    "ckks_alpha1_conjugate", "ckks_alpha1_hoisted_4_first", "ckks_alpha1_hoisted_17_first",
    "ckks_alpha1_hoisted_4_rescaled", "ckks_alpha1_hoisted_17_rescaled",
    "ckks_alpha1_batch_relinearize", "ckks_alpha1_split32", "ckks_alpha2_relinearize",
    "ckks_alpha2_fused", "ckks_level_L5", "ckks_level_L4", "ckks_level_L3", "ckks_level_L2",
    "bfv_relinearize", "bfv_rotate_rows", "bfv_rotate_columns", "bfv_hoisted",
    "bgv_relinearize", "bgv_rotate_rows", "bgv_rotate_columns", "bgv_hoisted")]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_split_key_switch_is_bit_exact_with_one_all_reduce(cases, name):
    """On every rank: the unsharded Evaluator's bits, and ONE all_reduce for
    the op's one key switch (NAF-free rotation, conjugation, relinearize of
    size 3, a hoisted batch however many steps)."""
    world, results = cases
    for res in results:
        ok, census = res[name]
        assert ok, (world, name)
        assert census["all_reduce"]["calls"] == 1, (world, name, census)
        assert set(census) == {"all_reduce"}, census
    # the split32 case carries two words per residue
    L_plus = {"ckks_alpha1_split32": 5, "ckks_alpha1_relinearize": 5}.get(name.split("/")[0])
    if L_plus:
        words = 2 if "split32" in name else 1
        assert results[0][name][1]["all_reduce"]["bytes"] == words * 2 * L_plus * N * 8


def test_split32_recombines_exactly():
    """_split32 / _recombine32 against Python integers: partials below
    61-bit primes, summed as a gloo all_reduce would, back to Σ mod q."""
    from seal_tpu_torch.ops.modring import make_mod_consts
    from seal_tpu_torch.parallel.keyswitch import _recombine32, _split32
    from seal_tpu_torch.utils import numth

    moduli = numth.get_primes(2 * N, 61, 3)
    mc = make_mod_consts(moduli, "cpu")
    rng = np.random.default_rng(5)
    parts = [torch.from_numpy(np.stack([rng.integers(0, q, N, dtype=np.int64) for q in moduli]))
             for _ in range(12)]
    got = _recombine32(sum(_split32(p) for p in parts), mc)
    want = [[sum(int(p[i, j]) for p in parts) % q for j in range(N)]
            for i, q in enumerate(moduli)]
    assert got.tolist() == want


def _carried(rank, arrays):
    """The port's TPEvaluator on inputs carried over from seal_tpu."""
    from seal_tpu_torch import interop
    from seal_tpu_torch.parallel import HEMesh, TPEvaluator

    hm = HEMesh(1, rank.world, device="cpu")
    ctx = _context(st.SchemeType.CKKS, [40] * 5)
    pid = ctx.first_parms_id
    rk = interop.relin_keys_from_numpy(ctx, arrays["rk"])
    gk = interop.galois_keys_from_numpy(ctx, arrays["gk"])
    cm = interop.ciphertext_from_numpy(ctx, arrays["cm"], pid, arrays["cm_scale"])
    ct = interop.ciphertext_from_numpy(ctx, arrays["ct"], pid, arrays["ct_scale"])
    tev = TPEvaluator(ctx, hm)
    hm.census.reset()
    relin = tev.relinearize(cm, rk).to_numpy()
    relin_census = hm.census.snapshot()
    hoisted = [c.to_numpy() for c in tev.rotate_batch_hoisted(ct, arrays["steps"], gk)]
    return dict(relin=relin, relin_census=relin_census, hoisted=hoisted)


def test_tp_matches_seal_tpu_tp_evaluator():
    """n = 64, 4 data primes and one special prime, tp = 2: seal_tpu's
    TPEvaluator (shard_map over 2 of the 8 virtual CPU devices, one psum of
    21-bit limbs) and the port's (2 gloo ranks, one int64 all_reduce) give
    the same words for relinearize and for a hoisted batch."""
    import jax
    from jax.sharding import Mesh

    import seal_tpu
    from seal_tpu.dtypes import to_host
    from seal_tpu.parallel.keyswitch import TPEvaluator

    parms = seal_tpu.EncryptionParameters(seal_tpu.SchemeType.CKKS)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(seal_tpu.CoeffModulus.create(N, [40] * 5))
    parms.set_random_seed(SEED)
    sctx = seal_tpu.SEALContext(parms, sec_level=seal_tpu.SecLevelType.NONE)
    kg = seal_tpu.KeyGenerator(sctx)
    rk = kg.create_relin_keys()
    gt = sctx.key_context_data().galois_tool
    steps = [1, 2, -1]
    gk = kg.create_galois_keys(gt.get_elts_from_steps(steps))
    enc = seal_tpu.Encryptor(sctx, kg.create_public_key())
    encoder = seal_tpu.ckks.CKKSEncoder(sctx)
    vals = np.linspace(-1, 1, N // 2)
    ct1 = enc.encrypt(encoder.encode(vals, 2.0 ** 30))
    ct2 = enc.encrypt(encoder.encode(vals + 0.5, 2.0 ** 30))
    cm = seal_tpu.Evaluator(sctx).multiply(ct1, ct2)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("dp", "tp"))
    tev = TPEvaluator(sctx, mesh)
    want_relin = tev.relinearize(cm, rk).to_numpy()
    want_hoisted = [c.to_numpy() for c in tev.rotate_batch_hoisted(ct1, steps, gk)]

    arrays = dict(rk=[to_host(k) for k in rk.keys],
                  gk=[None if k is None else to_host(k) for k in gk.keys],
                  cm=cm.to_numpy(), cm_scale=cm.scale, ct=ct1.to_numpy(),
                  ct_scale=ct1.scale, steps=steps)
    for res in launch.run(_carried, 2, "gloo", "cpu", LIMIT_S, args=(arrays,)):
        np.testing.assert_array_equal(res["relin"], want_relin)
        assert res["relin_census"]["all_reduce"]["calls"] == 1
        assert len(res["hoisted"]) == len(want_hoisted)
        for got, want in zip(res["hoisted"], want_hoisted):
            np.testing.assert_array_equal(got, want)
