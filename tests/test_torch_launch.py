"""parallel/launch.py: ranks spawned on gloo on the CPU, each group under its
own time limit. A rank that hangs is killed within the limit, a rank that
raises surfaces its traceback and output, and nothing falls back from the
device or backend it was given."""

import time

import pytest
import torch

from seal_tpu_torch.parallel import launch

LIMIT_S = 4.0


def _ok(rank, text):
    import torch.distributed as dist

    from seal_tpu_torch.parallel.comm import Census, Comm
    from seal_tpu_torch.parallel.sharding import HEMesh

    comm = Comm(dist.group.WORLD, "gloo", Census())
    total = comm.all_reduce_sum(torch.tensor([rank.rank + 1]))
    errors = {}
    # a group labelled NCCL refuses CPU tensors instead of running them on gloo
    try:
        Comm(dist.group.WORLD, "nccl", Census()).all_reduce_sum(torch.zeros(1))
    except ValueError as e:
        errors["nccl_cpu"] = str(e)
    if not torch.cuda.is_available():
        try:
            HEMesh(1, rank.world)
        except RuntimeError as e:
            errors["mesh_without_cuda"] = str(e)
    return dict(rank=rank.rank, world=rank.world, device=str(rank.device), text=text,
                total=int(total), census=comm.census.snapshot(), errors=errors)


def _hang(rank):
    if rank.rank == 1:
        print("rank 1 is about to hang", flush=True)
        time.sleep(3600)
    return rank.rank


def _raise(rank):
    if rank.rank == 1:
        print("rank 1 is about to raise", flush=True)
        raise ValueError("boom from rank 1")
    import torch.distributed as dist

    dist.barrier()          # rank 0 waits on rank 1, which never comes
    return rank.rank


def test_results_in_rank_order_and_no_fallback():
    out = launch.run(_ok, 2, "gloo", "cpu", 60, args=("hi",))
    assert [o["rank"] for o in out] == [0, 1]
    assert all(o["world"] == 2 and o["device"] == "cpu" and o["text"] == "hi" for o in out)
    assert [o["total"] for o in out] == [3, 3]
    assert out[0]["census"] == {"all_reduce": {"calls": 1, "bytes": 8, "staged": False}}
    assert all("NCCL takes CUDA tensors" in o["errors"]["nccl_cpu"] for o in out)
    if not torch.cuda.is_available():
        assert all("CUDA is not available" in o["errors"]["mesh_without_cuda"] for o in out)


def test_hung_rank_is_killed_within_its_limit():
    t0 = time.monotonic()
    with pytest.raises(launch.RankFailure) as err:
        launch.run(_hang, 2, "gloo", "cpu", LIMIT_S)
    elapsed = time.monotonic() - t0
    assert elapsed < LIMIT_S + launch._GRACE_S + 5
    msg = str(err.value)
    assert "rank 1: FAILED" in msg and f"after the {LIMIT_S} s limit" in msg
    assert "rank 1 is about to hang" in msg
    # the rank's stacks, dumped when it reached the limit
    assert "Timeout" in msg and "in _hang" in msg


def test_raising_rank_surfaces_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(launch.RankFailure) as err:
        launch.run(_raise, 2, "gloo", "cpu", 60)
    assert time.monotonic() - t0 < 30
    msg = str(err.value)
    assert "ValueError: boom from rank 1" in msg
    assert "Traceback" in msg and "in _raise" in msg
    assert "rank 1 is about to raise" in msg


def test_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="backend"):
        launch.run(_ok, 1, "mpi", "cpu", 10)
    with pytest.raises(ValueError, match="device"):
        launch.run(_ok, 1, "gloo", "tpu", 10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch.run(_ok, 1, "gloo", "cuda", 10)


def test_dryrun_defaults_to_nccl_on_the_card(monkeypatch):
    from seal_tpu_torch.parallel import dryrun

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.main([])
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(dryrun, "dryrun_multichip", lambda *a: calls.append(a) or [])
    assert dryrun.main([]) == 0
    world, backend, device, cfg, dp, _ = calls[0]
    assert (world, backend, device, cfg["n"], dp) == (4, "nccl", "cuda", 16384, 1)
    assert dryrun.main(["--backend", "gloo", "--device", "cpu", "--n", "1024"]) == 0
    assert calls[1][:4] == (2, "gloo", "cpu", dict(dryrun.FULL, n=1024, sec_level="none"))
