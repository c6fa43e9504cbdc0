"""Ciphertext-batch (DP) and RNS-tower (TP) sharding over a grid of ranks.

The port of seal_tpu/parallel/sharding.py. seal_tpu lays a (dp, tp) Mesh
over the devices of one process and lets XLA partition jitted ops; the port
runs one process per rank (launch.py), and `HEMesh` is the same grid over
the ranks of the default process group, r = d·tp + t, with a process group
per row (its tp group) and per column (its dp group):

* DP: a batch [B, size, L, N] splits over dp; `vmap_pipeline` runs a batched
  function on this rank's B/dp members and all_gathers the results over dp.
* TP: the port has no partitioner, so inside `vmap_pipeline` the tower is
  replicated over tp, and the key switch is the op that splits across tp,
  through keyswitch.TPEvaluator. A tower shard (`shard_ciphertext` of one
  ciphertext: this rank's L/tp rows, as P(None, "tp", None) lays them out)
  takes the row-local ops: `transform_to_ntt_rows` runs K1 on the local
  rows with their own tables (ContextData.ntt_rows), and `gather_tower`
  puts the rows back together.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from seal_tpu_torch.context import SEALContext
from seal_tpu_torch.dtypes import Ciphertext, stack_ciphertexts
from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.parallel.comm import Census, Comm


class HEMesh:
    """A (dp, tp) grid over the ranks of the default process group, which
    launch.run (or the caller) has initialised; every rank builds it, in the
    same order as every other group. `device` is where this rank's context
    lives: cuda:{rank mod the card count} by default (raises without CUDA),
    or the CPU when the caller passes device="cpu". The collectives of the
    grid share one census (`census`)."""

    def __init__(self, dp: int = 1, tp: int = 1, device=None):
        if not dist.is_initialized():
            raise RuntimeError("HEMesh needs an initialised default process group "
                               "(parallel.launch.run makes one per rank)")
        world, rank = dist.get_world_size(), dist.get_rank()
        if dp * tp != world:
            raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, the group has {world}")
        self.dp, self.tp = dp, tp
        self.dp_rank, self.tp_rank = divmod(rank, tp)
        self.backend = dist.get_backend()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available: pass device='cpu' to run the "
                                   "ranks on the CPU")
            device = torch.device("cuda", rank % torch.cuda.device_count())
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available")
        self.census = Census()
        tp_groups = [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)]
        dp_groups = [dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)]
        self.tp_comm = Comm(tp_groups[self.dp_rank], self.backend, self.census)
        self.dp_comm = Comm(dp_groups[self.tp_rank], self.backend, self.census)
        self.world_comm = Comm(dist.group.WORLD, self.backend, self.census)

    def tower_rows(self, L: int) -> slice:
        """This rank's rows of an L-row tower split over tp."""
        if L % self.tp:
            raise ValueError(f"a tower of {L} rows does not split over tp = {self.tp}")
        k = L // self.tp
        return slice(self.tp_rank * k, (self.tp_rank + 1) * k)

    def batch_rows(self, B: int) -> slice:
        """This rank's members of a batch of B split over dp."""
        if B % self.dp:
            raise ValueError(f"a batch of {B} does not split over dp = {self.dp}")
        k = B // self.dp
        return slice(self.dp_rank * k, (self.dp_rank + 1) * k)


def batch_ciphertexts(cts) -> Ciphertext:
    """Stack ciphertexts of one level, size, form, scale and correction
    factor into one batch [B, size, L, N]."""
    return stack_ciphertexts(cts)


def unbatch_ciphertexts(ct: Ciphertext) -> list[Ciphertext]:
    return ct.unbind()


def shard_ciphertext(ct: Ciphertext, hm: HEMesh, batched: bool = False) -> Ciphertext:
    """This rank's block: of a batch [B, size, L, N] its B/dp members, of one
    ciphertext [size, L, N] its L/tp tower rows (the metadata stays the
    full ciphertext's: the rows are for the row-local ops below)."""
    out = ct.copy()
    if batched:
        out.data = ct.data[hm.batch_rows(ct.data.shape[0])]
    else:
        out.data = ct.data[..., hm.tower_rows(ct.data.shape[-2]), :]
    return out


def transform_to_ntt_rows(context: SEALContext, shard: Ciphertext, hm: HEMesh) -> Ciphertext:
    """Evaluator.transform_to_ntt on a tower shard: K1 on the local rows."""
    if shard.is_ntt_form:
        raise ValueError("encrypted is already in NTT form")
    cd = context.get_context_data(shard.parms_id)
    out = shard.copy()
    out.data = ntt_mod.ntt_forward(shard.data, cd.ntt_rows(hm.tower_rows(cd.coeff_modulus_size)))
    out.is_ntt_form = True
    return out


def gather_tower(shard: Ciphertext, hm: HEMesh) -> Ciphertext:
    """The whole ciphertext from its tower shards: one all_gather over tp."""
    parts = hm.tp_comm.all_gather(shard.data)              # [tp, ..., L/tp, N]
    out = shard.copy()
    out.data = torch.cat(list(parts.unbind(0)), dim=-2)
    return out


def vmap_pipeline(fn, hm: HEMesh | None = None):
    """A batched pipeline over a dp x tp grid: the returned function takes
    batches [B, size, L, N] (and other arguments as they are), runs fn on
    this rank's B/dp members, and all_gathers fn's ciphertext over dp, so
    every rank returns the whole batch. fn is a batched function of the
    port (every Evaluator op takes a batch); to split its key switches over
    tp it uses a keyswitch.TPEvaluator on hm. Without a mesh fn runs as it
    is, on the whole batch."""
    if hm is None:
        return fn

    def sharded(*args):
        local = [shard_ciphertext(a, hm, batched=True) if isinstance(a, Ciphertext) else a
                 for a in args]
        out = fn(*local)
        parts = hm.dp_comm.all_gather(out.data)             # [dp, B/dp, ...]
        full = out.copy()
        full.data = parts.reshape((-1,) + tuple(parts.shape[2:]))
        return full

    return sharded
