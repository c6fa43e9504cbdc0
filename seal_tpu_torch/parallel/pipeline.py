"""Pipeline parallelism (PP): stage s of a pipeline on rank s of a group.

The port of seal_tpu/parallel/pipeline.py. seal_tpu runs the systolic
schedule inside one shard_map, every device computing every step and
handing its result on with ppermute; here each rank runs its own stage
and the hand-over is a send to the next rank (Comm.ring_shift). A batch of
M microbatches streams through P stages in M + P - 1 steps: at step t, rank
s works on microbatch t - s, where 0 <= t - s < M, and is idle otherwise
(seal_tpu's devices compute on padding there; a rank here skips it, so a
stage never sees anything but a real microbatch).

Stages are shape-preserving functions of one tensor (a ciphertext payload,
say [4, L, N] for the two operands of a multiply); for integer payloads the
result is the sequential composition bit for bit.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.parallel.comm import Comm


def interleave_microbatches(stage_fns, microbatches):
    """Every microbatch through every stage, on one device, in input order:
    [compose(stage_fns)(x) for x in microbatches]."""
    outs = []
    for x in microbatches:
        for f in stage_fns:
            x = f(x)
        outs.append(x)
    return outs


def _check_stages(stage_fns, comm: Comm):
    if comm.size != len(stage_fns):
        raise ValueError(f"{len(stage_fns)} stages need {len(stage_fns)} ranks, the group "
                         f"has {comm.size}")


def _step(stage_fns, comm: Comm, t: int, M: int, x, like: torch.Tensor):
    """Step t of the schedule on this rank: its stage on x, microbatch t - s
    (what rank 0 injects, or what the others received), where there is one;
    then the hand-over to the next rank. `like` is a tensor of the payload's
    shape. Returns (the stage's output or None, what this rank received for
    step t + 1 or None)."""
    s, P = comm.rank, comm.size
    done = stage_fns[s](x) if 0 <= t - s < M else None
    send = done is not None and s < P - 1
    recv = s > 0 and 0 <= t + 1 - s < M
    if not (send or recv):
        return done, None
    return done, comm.ring_shift(done if send else like, send=send, recv=recv)


def pipeline_apply(stage_fns, xs: torch.Tensor, comm: Comm) -> torch.Tensor:
    """xs [M, ...] (the same on every rank) through stage_fns[s] on rank s of
    `comm`; every rank returns the outputs [M, ...] in microbatch order (the
    last stage's, added over the group with one all_reduce, as seal_tpu's
    psum of zeros elsewhere)."""
    _check_stages(stage_fns, comm)
    M, P = xs.shape[0], comm.size
    out = torch.zeros_like(xs)
    cur = None
    for t in range(M + P - 1):
        x = xs[min(t, M - 1)] if comm.rank == 0 else cur
        done, cur = _step(stage_fns, comm, t, M, x, xs[0])
        if done is not None and comm.rank == P - 1:
            out[t - (P - 1)] = done
    return comm.all_reduce_sum(out)


def cyclic_feed(xs: torch.Tensor, comm: Comm) -> torch.Tensor:
    """This rank's share of xs [M, ...] in the cyclic layout of
    pipeline_apply_sharded: microbatches rank, rank + P, ... ([M/P, ...])."""
    if xs.shape[0] % comm.size:
        raise ValueError(f"microbatch count {xs.shape[0]} not divisible by {comm.size}")
    return xs[comm.rank::comm.size]


def gather_cyclic(local: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Inverse of cyclic_feed over the group (one all_gather): [M, ...]."""
    parts = comm.all_gather(local)                  # [P, M/P, ...]
    return parts.movedim(0, 1).reshape((-1,) + tuple(local.shape[1:]))


def pipeline_apply_sharded(stage_fns, feed: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The systolic schedule with the feed split over the ranks: `feed` is
    this rank's cyclic share [M/P, ...] (cyclic_feed), and the result is its
    share of the outputs in the same layout. Each chunk of P consecutive
    microbatches is one all_gather away when it enters the pipeline, and
    returns to its owners with one reduce_scatter when it leaves it, so a
    rank holds O(M/P + P) microbatches, as in seal_tpu."""
    _check_stages(stage_fns, comm)
    P = comm.size
    M = feed.shape[0] * P
    cur, chunk = None, None
    out_roll = torch.zeros((P,) + tuple(feed.shape[1:]), dtype=feed.dtype,
                           device=feed.device)
    outs = []
    for t in range(M + P - 1):
        if t < M and t % P == 0:
            chunk = comm.all_gather(feed[t // P])    # [P, ...]: microbatches t..t+P-1
        x = (chunk[t % P] if t < M else None) if comm.rank == 0 else cur
        done, cur = _step(stage_fns, comm, t, M, x, feed[0])
        m = t - (P - 1)
        if m >= 0:
            if done is not None and comm.rank == P - 1:
                out_roll[m % P] = done
            if m % P == P - 1:
                outs.append(comm.reduce_scatter(out_roll))
                out_roll = torch.zeros_like(out_roll)
    return torch.stack(outs)
