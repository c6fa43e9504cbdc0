"""BFV/BGV plaintexts brought into the ciphertext modulus Q.

A coefficient-form plaintext (coefficients mod t) enters Q three ways:
Δ-scaled (BFV's encryption and plain add/sub, SEAL util/scalingvariant.cpp),
lifted as it is (BGV's), or lifted with its upper half of t sent to the
negatives (multiply_plain, both schemes). The Encryptor and the Evaluator
both call these; every step runs on the context's device. A batch of
plaintexts [*batch, <= N] gives coefficients [*batch, N] and rows [*batch,
L, N].
"""

from __future__ import annotations

import torch

from seal_tpu_torch.context import ContextData
from seal_tpu_torch.dtypes import Plaintext
from seal_tpu_torch.ops import modarith


def plain_coeffs(plain: Plaintext, cd: ContextData) -> torch.Tensor:
    """A coefficient-form plaintext as [*batch, N] int64 on the context's
    device."""
    if plain.is_ntt_form:
        raise ValueError("plain cannot be in NTT form")
    n = cd.parms.poly_modulus_degree
    data = plain.data
    if data.dim() == 0:
        data = data.reshape(1)
    if data.shape[-1] > n:
        raise ValueError("plain is not valid for encryption parameters")
    out = torch.zeros(data.shape[:-1] + (n,), dtype=torch.int64, device=cd.device)
    out[..., :data.shape[-1]] = data
    return out


def scaled_plain_rows(m: torch.Tensor, cd: ContextData) -> torch.Tensor:
    """Δ·m + ⌊((Q mod t)·m + ⌊(t+1)/2⌋) / t⌋ mod q_i for coefficients m [N]
    below t: [L, N] (scalingvariant.cpp:69-113, seal_tpu's
    _scaled_plain_rows)."""
    c, mc = cd.plain_consts, cd.mod_consts
    m = m.unsqueeze(-2)
    t_mc = c["t_mc"]
    lo, hi = modarith.mul_wide(m, c["q_mod_t"][0])
    lo, carry = modarith.add_carry(lo, c["threshold"][0])
    fix = modarith.divide_128(lo, hi + carry, t_mc.q[0], t_mc.ratio0[0], t_mc.ratio1[0])
    lo, hi = modarith.mul_wide(c["delta"], m)
    lo, carry = modarith.add_carry(lo, fix)
    return modarith.barrett_reduce_128(lo, hi + carry, mc.q, mc.ratio0, mc.ratio1)


def lifted_plain_rows(m: torch.Tensor, cd: ContextData) -> torch.Tensor:
    """Coefficients m [N] below t as residues [L, N], without scaling."""
    mc = cd.mod_consts
    return modarith.barrett_reduce_64(m.unsqueeze(-2), mc.q, mc.ratio1)


def plain_to_rns_rows(m: torch.Tensor, cd: ContextData) -> torch.Tensor:
    """Coefficients m [N] below t lifted to residues [L, N], the upper half
    of t (>= ⌈t/2⌉) to v + Q - t (evaluator.cpp multiply_plain_normal,
    seal_tpu's _plain_to_rns_rows)."""
    mc, c = cd.mod_consts, cd.plain_consts
    rows = lifted_plain_rows(m, cd)
    return torch.where(m.unsqueeze(-2) >= c["threshold"][0],
                       modarith.add_mod(rows, c["upper_half_increment"], mc.q), rows)
