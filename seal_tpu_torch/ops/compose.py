"""CRT composition: RNS residues [L, N] -> the integers mod Q as multi-word
values, on the residues' device.

The CKKS decoder (ckks.h:694-731) and the noise budget (decryptor.cpp
invariant_noise_budget) need each coefficient as one integer below
Q = Π q_i. seal_tpu composes them on the host with Python integers or its
C++ library; here the composition is tensor arithmetic on the context's
device, in 32-bit limbs held in int64 tensors:

    v = Σ_i y_i·(Q/q_i) - k·Q,   y_i = x_i·[(Q/q_i)^{-1}]_{q_i} mod q_i,

with each 61×32-bit product y_i·limb formed by modarith.mul_wide and split
into 32-bit limbs. The column sums stay below 2^40, so they are exact in
int64, and one carry pass normalises them. k = floor(Σ_i y_i/q_i) is found
in float64, which may miss by one either way near an integer; the
subtraction therefore takes one k less and two conditional subtractions of
Q follow. `compose_plain` is the same function over Python integers, for
the tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from seal_tpu_torch.ops import modarith
from seal_tpu_torch.ops.modring import shoup_pair, u64_tensor

LIMB = 32
M32 = (1 << LIMB) - 1


def limbs_of(value: int, count: int) -> list[int]:
    return [(value >> (LIMB * k)) & M32 for k in range(count)]


class ComposeConsts(NamedTuple):
    q: torch.Tensor             # [L, 1] the moduli
    inv_punct: tuple            # Shoup pair [L, 1] of [(Q/q_i)^{-1}]_{q_i}
    punct: torch.Tensor         # [L, W, 1] 32-bit limbs of Q/q_i
    q_inv_f: torch.Tensor       # [L, 1] float64 1/q_i
    Q: torch.Tensor             # [W + 2, 1] 32-bit limbs of Q
    half: torch.Tensor          # [W + 2, 1] limbs of (Q + 1) / 2
    words: int                  # W + 2, the limbs of a composed value


def make_compose_consts(moduli, device) -> ComposeConsts:
    moduli = [int(q) for q in moduli]
    Q = 1
    for q in moduli:
        Q *= q
    W = -(-Q.bit_length() // LIMB)
    puncts = [Q // q for q in moduli]
    return ComposeConsts(
        q=u64_tensor([[q] for q in moduli], device),
        inv_punct=shoup_pair([[pow(p % q, -1, q)] for p, q in zip(puncts, moduli)],
                             [[q] for q in moduli], device),
        punct=u64_tensor([limbs_of(p, W) for p in puncts], device).unsqueeze(-1),
        q_inv_f=torch.tensor([[1.0 / q] for q in moduli], dtype=torch.float64,
                             device=device),
        Q=u64_tensor([[w] for w in limbs_of(Q, W + 2)], device),
        half=u64_tensor([[w] for w in limbs_of((Q + 1) >> 1, W + 2)], device),
        words=W + 2,
    )


def _normalise(acc: torch.Tensor) -> torch.Tensor:
    """Propagate carries and borrows so every limb is in [0, 2^32); the
    arithmetic shift floors, so negative limbs borrow from the next."""
    limbs = list(acc.unbind(0))
    for k in range(len(limbs) - 1):
        limbs[k + 1] = limbs[k + 1] + (limbs[k] >> LIMB)
        limbs[k] = limbs[k] & M32
    return torch.stack(limbs)


def sub_limbs(a: torch.Tensor, b: torch.Tensor):
    """(a - b normalised, a < b) for limb tensors [W, ...] (b may broadcast)."""
    d = _normalise(a - b)
    return d, d[-1] < 0


def compose(x: torch.Tensor, c: ComposeConsts) -> torch.Tensor:
    """Residues x [..., L, N] (each row below its prime) -> the integers
    mod Q as limbs [W + 2, ..., N], least significant first, each in
    [0, 2^32). Each coefficient composes on its own, so a batch gives each
    member's limbs."""
    lead = x.shape[:-2]
    if lead:
        flat = x.movedim(-2, 0).reshape(x.shape[-2], -1)
        return compose(flat, c).reshape((c.words,) + lead + x.shape[-1:])
    L, n = x.shape
    y = modarith.mul_mod_shoup(x, *c.inv_punct, c.q)                  # [L, N]
    lo, hi = modarith.mul_wide(y.unsqueeze(1), c.punct)               # [L, W, N]
    acc = torch.zeros((c.words, n), dtype=torch.int64, device=x.device)
    W = c.words - 2
    acc[:W] += (lo & M32).sum(0)
    acc[1:W + 1] += ((lo >> LIMB) & M32).sum(0)
    acc[2:] += hi.sum(0)
    # k = floor(Σ y_i/q_i), one less to stay at or below the true quotient
    k = torch.floor((y.to(torch.float64) * c.q_inv_f).sum(0)) - 1
    acc = _normalise(acc - k.clamp(min=0).to(torch.int64) * c.Q)
    for _ in range(2):
        d, below = sub_limbs(acc, c.Q)
        acc = torch.where(below, acc, d)
    return acc


def bit_length(limbs: torch.Tensor) -> torch.Tensor:
    """Bit length of each limb value [W, N] -> [N] int64."""
    _, exp = torch.frexp(limbs.to(torch.float64))                       # limb < 2^32: exact
    k = torch.arange(limbs.shape[0], device=limbs.device).unsqueeze(-1)
    bits = torch.where(limbs > 0, LIMB * k + exp.to(torch.int64), 0)
    return bits.max(0).values


def compose_plain(rows, moduli) -> list[int]:
    """The same composition over Python integers: rows [L][N] -> [N] ints."""
    Q = 1
    for q in moduli:
        Q *= q
    out = []
    for col in zip(*rows):
        v = 0
        for x, q in zip(col, moduli):
            p = Q // q
            v += int(x) * pow(p % q, -1, q) % q * p
        out.append(v % Q)
    return out
