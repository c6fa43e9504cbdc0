"""parallel/pipeline.py on gloo ranks on the CPU: stage s on rank s, the
microbatches streamed through pipeline_apply (the feed on every rank) and
pipeline_apply_sharded (the feed split cyclically over the ranks), against
the sequential composition, bit for bit, at 2 and 4 stages; the census of
each schedule. Pipelines of real Evaluator stages run in
tests/test_torch_parallel.py (dryrun's pp leg).
"""

import types

import numpy as np
import pytest
import torch

from seal_tpu_torch.ops import modarith
from seal_tpu_torch.ops.modring import make_mod_consts, shoup_pair
from seal_tpu_torch.parallel import launch, pipeline
from seal_tpu_torch.utils import numth

LIMIT_S = 60
N = 256
CONSTANTS = (3, 5, 7, 11)


def _stages(count, moduli):
    """Shape-preserving stages: x · c mod q for one constant c each."""
    mc = make_mod_consts(moduli, "cpu")

    def stage(c):
        op, qt = shoup_pair([[c % q] for q in moduli], [[q] for q in moduli], "cpu")
        return lambda x: modarith.mul_mod_shoup(x, op, qt, mc.q)

    return [stage(c) for c in CONSTANTS[:count]]


def _feed(M, moduli, seed=5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([
        np.stack([rng.integers(0, q, N, dtype=np.int64) for q in moduli]) for _ in range(M)]))


def _pipelines(rank, M):
    from seal_tpu_torch.parallel.sharding import HEMesh

    hm = HEMesh(1, rank.world, device="cpu")
    comm = hm.world_comm
    moduli = numth.get_primes(2 * N, 40, 2)
    stages, xs = _stages(rank.world, moduli), _feed(M, moduli)
    out = {}
    hm.census.reset()
    out["apply"] = pipeline.pipeline_apply(stages, xs, comm)
    out["apply_census"] = hm.census.snapshot()
    hm.census.reset()
    local = pipeline.pipeline_apply_sharded(stages, pipeline.cyclic_feed(xs, comm), comm)
    out["sharded_census"] = hm.census.snapshot()
    out["sharded"] = pipeline.gather_cyclic(local, comm)
    out["sharded_local"] = local
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["pp2", "pp4"])
def runs(request):
    P = request.param
    M = 2 * P
    return P, M, launch.run(_pipelines, P, "gloo", "cpu", LIMIT_S, args=(M,))


def _sequential(P, M):
    moduli = numth.get_primes(2 * N, 40, 2)
    return torch.stack(pipeline.interleave_microbatches(
        _stages(P, moduli), list(_feed(M, moduli).unbind(0))))


def test_pipeline_apply_matches_sequential(runs):
    P, M, results = runs
    want = _sequential(P, M)
    for rank, res in enumerate(results):
        assert torch.equal(res["apply"], want), rank
        census = res["apply_census"]
        # every rank but the last hands each microbatch on, every rank but
        # the first takes it in; one all_reduce replicates the outputs
        assert census.get("send", {}).get("calls", 0) == (M if rank < P - 1 else 0)
        assert census.get("recv", {}).get("calls", 0) == (M if rank > 0 else 0)
        assert census["all_reduce"]["calls"] == 1


def test_pipeline_apply_sharded_matches_sequential(runs):
    P, M, results = runs
    want = _sequential(P, M)
    for rank, res in enumerate(results):
        assert torch.equal(res["sharded"], want), rank
        # this rank's share: microbatches rank, rank + P, ...
        assert torch.equal(res["sharded_local"], want[rank::P]), rank
        census = res["sharded_census"]
        assert census["reduce_scatter"]["calls"] == M // P
        # one all_gather per chunk of P microbatches fed in
        assert census["all_gather"]["calls"] == M // P


def test_interleave_microbatches():
    fns = [lambda x: x + 1, lambda x: x * 2]
    assert pipeline.interleave_microbatches(fns, [1, 5]) == [4, 12]


def test_schedule_refuses_bad_shapes():
    comm = types.SimpleNamespace(size=2, rank=0)
    with pytest.raises(ValueError, match="3 stages need 3 ranks"):
        pipeline.pipeline_apply([abs] * 3, torch.zeros(4, 2), comm)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.cyclic_feed(torch.zeros(3, 2), comm)
