"""Run a function on a group of ranks, one process each, with a time limit.

    results = launch.run(fn, world=2, backend="gloo", device="cpu", timeout_s=60,
                         args=(cfg,))

`run` starts `world` processes with torch.multiprocessing's `spawn` method
(CUDA does not survive a fork). Rank r initialises the default process group
of the named backend through a FileStore in a temporary directory (TCP ports
would race between concurrent runs), then calls fn(rank, *args) with a
`Rank` (its rank, the world size, the backend and its torch.device: the CPU,
or cuda:{r mod the card count}), and sends fn's result back pickled, its
tensors moved to the CPU. `run` returns the results in rank order.

One limit, timeout_s, bounds everything: the group's initialisation and
every collective (the process group's timeout), each rank (its stacks are
dumped to its output when it reaches the limit) and the wait for all of them
(the parent kills every rank a few seconds later). A rank that raises, dies
or outlives the limit fails the run: every rank is killed, and the error
carries each rank's traceback and output. With device "cuda" the parent
builds the CUDA kernels first, so that the ranks only load them.

The counterpart of the process setup of tools/multihost_runner.py (JAX's
multi-process CPU simulation over gloo).
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch

# the parent waits this long past the limit for the ranks' own timeouts and
# stack dumps before it kills them
_GRACE_S = 5.0


@dataclass(frozen=True)
class Rank:
    rank: int
    world: int
    backend: str
    device: torch.device


class RankFailure(RuntimeError):
    """A rank raised, died or outlived its limit; the message holds every
    rank's traceback and output."""


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _rank_device(rank: int, device: str) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run the ranks on "
                           "the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(fn, rank, world, backend, device, store_path, out_path, timeout_s, started,
               args, results):
    import torch.distributed as dist

    out = open(out_path, "w")
    os.dup2(out.fileno(), 1)
    os.dup2(out.fileno(), 2)
    sys.stdout.reconfigure(line_buffering=True)
    sys.stderr.reconfigure(line_buffering=True)
    # dump every thread's stack when the run's limit is reached
    faulthandler.dump_traceback_later(max(1.0, started + timeout_s - time.time()), exit=False)
    torch.set_num_threads(1)
    try:
        dev = _rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        result = fn(Rank(rank, world, backend, dev), *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        results.put((rank, True, pickle.dumps(_to_cpu(result))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        faulthandler.cancel_dump_traceback_later()
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn, world: int, backend: str, device: str, timeout_s: float, args=()) -> list:
    """fn(Rank, *args) on `world` ranks; their results in rank order. fn
    and args are pickled into each rank, so fn is a module-level function."""
    from seal_tpu_torch.parallel.comm import BACKENDS

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    _rank_device(0, device)
    if world < 1:
        raise ValueError("world must be at least 1")
    if device == "cuda":
        from seal_tpu_torch import cuda

        cuda.build()
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="seal_tpu_torch-ranks-")
    results = ctx.Queue()
    outs = [os.path.join(tmp, f"rank{r}.out") for r in range(world)]
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world, backend, device, os.path.join(tmp, "store"), outs[r], timeout_s,
        time.time(), tuple(args), results)) for r in range(world)]
    got: dict = {}
    errors: dict = {}
    silent: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s + _GRACE_S
        while len(got) < world and not errors:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                # a rank that died without a word (killed, a crash) fails the
                # run once its last message, if any, has had time to arrive
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if r not in got and p.exitcode not in (None, 0):
                        if now - silent.setdefault(r, now) > 2.0:
                            errors[r] = f"exited with code {p.exitcode}"
                continue
            if ok:
                got[rank] = pickle.loads(payload)
            else:
                errors[rank] = payload
        if len(got) < world and not errors:
            errors = {r: f"still running after the {timeout_s} s limit"
                      for r in range(world) if r not in got}
        for p in procs:
            p.join(timeout=_GRACE_S if not errors else 0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=_GRACE_S)
        results.close()
        report = "\n".join(_report(r, errors.get(r), outs[r]) for r in range(world))
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RankFailure(f"{len(errors)} of {world} ranks failed ({backend}, {device}):\n"
                          + report)
    return [got[r] for r in range(world)]


def _report(rank: int, error, out_path: str) -> str:
    try:
        with open(out_path) as f:
            output = f.read()
    except OSError:
        output = ""
    head = f"--- rank {rank}: " + ("ok" if error is None else "FAILED")
    body = "" if error is None else f"\n{error}"
    return f"{head}{body}\n--- rank {rank} output:\n{output}"
