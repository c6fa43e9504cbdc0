"""parallel/ on gloo ranks on the CPU: dryrun.run_legs at n = 256 on a 1 x 2
and a 2 x 2 grid (DP x TP batches, tower shards, the split key switches,
the four-step NTT over 2 and 4 shards by both routes, pipelines of real
Evaluator stages), every record bit for bit the unsharded port on every
rank; and the four-step NTT on one device against K1's plain version and
against seal_tpu's fourstep.ntt_forward_local.
"""

import numpy as np
import pytest
import torch

from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.parallel import dryrun, fourstep
from seal_tpu_torch.utils import numth

LIMIT_S = 120
CFG = dict(dryrun.FULL, n=256, sec_level="none", batch=4, steps=[1, 2, -1, 0], sp_rows=3,
           microbatches=4, reps=1,
           modes={"alpha2_fused": dict(bits=[40] * 4 + [40] * 2, alpha=2, fused=True),
                  "alpha1_parity": dict(bits=[40] * 4 + [41], alpha=1, fused=False)})
GRIDS = {"1x2": (2, 1), "2x2": (4, 2)}          # world, dp


@pytest.fixture(scope="module", params=sorted(GRIDS))
def grid(request):
    world, dp = GRIDS[request.param]
    return request.param, dryrun.dryrun_multichip(world, "gloo", "cpu", CFG, dp=dp,
                                                  timeout_s=LIMIT_S)


RECORDS = ([f"{mode}/{op}/{tag}" for mode in CFG["modes"] for tag in ("k2", "shoup")
            for op in ("relinearize", "relinearize_rescale", "hoisted", "dp_tp")]
           + [f"{mode}/{op}" for mode in CFG["modes"] for op in ("tower", "pp", "pp_sharded")]
           + ["sp/gather", "sp/a2a"])


@pytest.mark.parametrize("name", RECORDS)
def test_leg_is_bit_exact_on_every_rank(grid, name):
    label, results = grid
    for res in results:
        rec = res["records"][name]
        assert rec["bit_exact"], (label, res["rank"], name)
        assert all(not e["staged"] for e in rec["census"].values())
        # on the CPU every kernel runs as its plain version: no launch
        assert not any(rec["launches"].values())


def test_grid_shapes_and_census(grid):
    """The dp x tp layout, and the census of the legs that split: one
    all_reduce per key switch (dryrun.check), the batch gathered over dp
    with one all_gather, the tower with one, the four-step routes with one
    all_gather or two all_to_alls."""
    label, results = grid
    world, dp = GRIDS[label]
    tp = world // dp
    assert [(r["rank"], r["dp"], r["tp"]) for r in results] == [(r, dp, tp) for r in range(world)]
    for res in results:
        recs = res["records"]
        dp_tp = recs["alpha1_parity/dp_tp/k2"]
        assert dp_tp["census"]["all_gather"]["calls"] == 1
        L, n = 4, CFG["n"]
        assert dp_tp["census"]["all_reduce"]["bytes"] == \
            CFG["batch"] // dp * dryrun.port_model_bytes(L, 1, n)
        assert recs["alpha1_parity/tower"]["rows"] == L // tp
        assert recs["sp/gather"]["census"] == {
            "all_gather": {"calls": 1, "bytes": CFG["sp_rows"] * n * 8, "staged": False}}
        assert recs["sp/a2a"]["census"]["all_to_all"]["calls"] == 2
        assert recs["sp/a2a"]["route"] == "a2a" and recs["sp/a2a"]["shards"] == world


def _tower(log_n, count, bits=50, seed=3):
    n = 1 << log_n
    moduli = numth.get_primes(2 * n, bits, count)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(np.stack([rng.integers(0, q, n, dtype=np.int64) for q in moduli]))
    return moduli, x


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_fourstep_local_is_k1(shards):
    """One device, the shard axis a batch axis: K1's forward and inverse
    (ops/ntt.py's plain versions) bit for bit, at n = 1024."""
    log_n = 10
    moduli, x = _tower(log_n, 3)
    t = ntt_mod.make_ntt_tables(log_n, moduli, "cpu")
    t4 = fourstep.build_fourstep_tables(log_n, moduli, shards, "cpu")
    fwd = fourstep.ntt_forward_local(x, t4)
    assert torch.equal(fwd, ntt_mod.ntt_forward_plain(x, t))
    assert torch.equal(fourstep.ntt_inverse_local(fwd, t4), ntt_mod.ntt_inverse_plain(fwd, t))
    assert torch.equal(fourstep.ntt_inverse_local(fwd, t4), x)


def test_fourstep_tables_refuse_bad_splits():
    moduli, _ = _tower(4, 1)
    with pytest.raises(ValueError, match="power of two"):
        fourstep.build_fourstep_tables(4, moduli, 3, "cpu")
    with pytest.raises(ValueError, match="at least 4"):
        fourstep.build_fourstep_tables(4, moduli, 8, "cpu")


def test_fourstep_local_matches_seal_tpu():
    """n = 256 over 4 shards: the port's one-device four-step forward
    against seal_tpu's fourstep.ntt_forward_local (under one jax.jit),
    word for word."""
    import jax

    from seal_tpu.ops import limb
    from seal_tpu.parallel import fourstep as sfourstep

    log_n = 8
    moduli, x = _tower(log_n, 3, bits=40, seed=7)
    xs = limb.arr_to_u64(x.numpy().astype(np.uint64).tolist(), shape=(3, 1 << log_n))
    want = jax.jit(sfourstep.ntt_forward_local)(
        xs, sfourstep.build_fourstep_tables(log_n, moduli, 4))
    got = fourstep.ntt_forward_local(x, fourstep.build_fourstep_tables(log_n, moduli, 4, "cpu"))
    want64 = (np.asarray(want[1]).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(want[0]).astype(np.uint64)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want64)
