"""The collectives of seal_tpu_torch.parallel, and their census.

This is the one module of the port that calls torch.distributed. seal_tpu
runs one process over a Mesh of devices and lets shard_map place psum,
all_gather, all_to_all, psum_scatter and ppermute; the port runs one
process per rank, and each of those becomes a call here on a process group:

    all_reduce_sum   psum
    all_gather       all_gather (stacked on a new leading axis)
    all_to_all       all_to_all over the leading axis
    reduce_scatter   psum_scatter over the leading axis
    ring_shift       ppermute to the next rank of the group

The caller names the backend, and a `Comm` never changes it:
* "nccl": CUDA tensors across cards; a CPU tensor is refused;
* "gloo" with CPU tensors;
* "gloo" with CUDA tensors, for several ranks on one card: the tensor is
  copied to the host, the collective runs there, and the result is copied
  back to the tensor's device. The census marks such a collective
  `"staged": true`.

`Census` counts, per collective, its calls and the bytes of its result on
this rank (the convention of the compiled-HLO census in
__graft_entry__.py, which reads each collective's result shape); the
counterpart of that census for a process group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


class Census:
    """Calls and result bytes per collective, for every Comm that shares it."""

    def __init__(self):
        self.ops: dict = {}

    def record(self, op: str, result: torch.Tensor, staged: bool):
        entry = self.ops.setdefault(op, {"calls": 0, "bytes": 0, "staged": False})
        entry["calls"] += 1
        entry["bytes"] += result.numel() * result.element_size()
        entry["staged"] = entry["staged"] or staged

    def reset(self):
        self.ops.clear()

    def snapshot(self) -> dict:
        return {op: dict(entry) for op, entry in sorted(self.ops.items())}


class Comm:
    """The collectives of one process group over one backend; `size` and
    `rank` are the group's, `ranks` its members' global ranks."""

    def __init__(self, group, backend: str, census: Census):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        self.group = group
        self.backend = backend
        self.census = census
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = dist.get_process_group_ranks(group)

    def _to_backend(self, x: torch.Tensor):
        """(x, contiguous, where the backend runs: x itself where it already
        is, else a host copy; staged). Only all_reduce_sum writes its input,
        and it copies first."""
        if self.backend == "nccl":
            if x.device.type != "cuda":
                raise ValueError(f"NCCL takes CUDA tensors, got one on {x.device}")
            return x.contiguous(), False
        if x.device.type == "cuda":
            return x.to("cpu", copy=True).contiguous(), True
        return x.contiguous(), False

    def _done(self, op: str, out: torch.Tensor, like: torch.Tensor, staged: bool):
        self.census.record(op, out, staged)
        return out.to(like.device) if staged else out

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x (int64 sums wrap as the backend's do:
        the caller keeps them below 2^63)."""
        y, staged = self._to_backend(x)
        if not staged:
            y = y.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return self._done("all_reduce", y, x, staged)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape]: row p is rank p's x."""
        y, staged = self._to_backend(x)
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y, group=self.group)
        return self._done("all_gather", torch.stack(parts), x, staged)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [size, ...] -> out [size, ...]: out[p] is rank p's x[self.rank]."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all takes [{self.size}, ...], got {tuple(x.shape)}")
        y, staged = self._to_backend(x)
        out = torch.empty_like(y)
        dist.all_to_all_single(out, y, group=self.group)
        return self._done("all_to_all", out, x, staged)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """x [size, ...] -> Σ over ranks of x[self.rank]. One all_to_all
        and a local sum (gloo has no reduce_scatter in every torch build);
        exact for int64 sums below 2^63."""
        if x.shape[0] != self.size:
            raise ValueError(f"reduce_scatter takes [{self.size}, ...], got {tuple(x.shape)}")
        y, staged = self._to_backend(x)
        out = torch.empty_like(y)
        dist.all_to_all_single(out, y, group=self.group)
        return self._done("reduce_scatter", out.sum(0), x, staged)

    def ring_shift(self, x: torch.Tensor, send: bool = True, recv: bool = True):
        """Send x to the next rank of the group (if `send`) and receive a
        tensor of x's shape from the previous one (if `recv`), as one batch
        of point-to-point operations; returns what was received, or None.
        Every rank's flags must pair up: rank r sends exactly when rank r+1
        receives."""
        nxt = self.ranks[(self.rank + 1) % self.size]
        prev = self.ranks[(self.rank - 1) % self.size]
        y, staged = self._to_backend(x)
        buf = torch.empty_like(y)
        ops = ([dist.P2POp(dist.isend, y, nxt, self.group)] if send else []) + \
              ([dist.P2POp(dist.irecv, buf, prev, self.group)] if recv else [])
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if send:
            self.census.record("send", y, staged)
        if not recv:
            return None
        return self._done("recv", buf, x, staged)
