"""The CKKS rescale by the last prime.

The port of the CKKS parts of seal_tpu/ops/rns.py (SEAL util/rns.cpp): the
q_last constants of RNSTool and divide_and_round_q_last_ntt. The BFV/BGV
tools (BEHZ, {t, γ} decryption) are later slices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from seal_tpu_torch.ops import modarith
from seal_tpu_torch.ops import ntt as ntt_mod
from seal_tpu_torch.ops.modring import ModConsts, shoup_pair, u64_tensor
from seal_tpu_torch.utils import numth


class RescaleConsts(NamedTuple):
    """Device constants for dividing by the last prime of a tower
    (SEAL RNSTool::initialize, rns.cpp:578-787, CKKS entries)."""

    q_last_half: torch.Tensor       # [1, 1]: q_last >> 1
    neg_half_mod_q: torch.Tensor    # [L-1, 1]: q_i - ((q_last >> 1) mod q_i)
    inv_q_last_op: torch.Tensor     # [L-1, 1]: q_last^{-1} mod q_i, Shoup pair
    inv_q_last_qt: torch.Tensor


def make_rescale_consts(moduli, device) -> RescaleConsts:
    last, keep = moduli[-1], moduli[:-1]
    half = last >> 1
    inv_op, inv_qt = shoup_pair(
        [[numth.invert_uint_mod(last, q)] for q in keep], [[q] for q in keep], device)
    return RescaleConsts(
        q_last_half=u64_tensor([[half]], device),
        neg_half_mod_q=u64_tensor([[q - half % q] for q in keep], device),
        inv_q_last_op=inv_op, inv_q_last_qt=inv_qt)


def divide_and_round_q_last_ntt(x, rc: RescaleConsts,
                                keep_tables: ntt_mod.NTTTables,
                                last_tables: ntt_mod.NTTTables):
    """Rescale by the last prime in the NTT domain (SEAL rns.cpp:830-901).
    x: [..., L, N] in NTT form; keep_tables / last_tables cover its prime
    rows [0, L-1) and [L-1]. Returns [..., L-1, N] in NTT form."""
    keep_mc: ModConsts = keep_tables.mc
    last = ntt_mod.ntt_inverse(x[..., -1:, :], last_tables)
    last = modarith.add_mod(last, rc.q_last_half, last_tables.mc.q)
    temp = modarith.barrett_reduce_64(last, keep_mc.q, keep_mc.ratio1)
    temp = ntt_mod.ntt_forward(temp + rc.neg_half_mod_q, keep_tables, lazy=True)
    diff = x[..., :-1, :] + (keep_mc.q << 2) - temp        # < 5q
    return modarith.mul_mod_shoup(diff, rc.inv_q_last_op, rc.inv_q_last_qt, keep_mc.q)
