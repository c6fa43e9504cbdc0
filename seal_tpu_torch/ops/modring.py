"""Per-prime constants and coefficient-wise polynomial ops mod q.

The port of seal_tpu/ops/modring.py (SEAL's polyarithsmallmod layer): every
op is an elementwise computation over RNS tensors [..., L, N] of int64, with
per-prime constants broadcast from [L, 1].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from seal_tpu_torch.ops import modarith


def u64_tensor(values, device, shape=None) -> torch.Tensor:
    """Python ints (< 2^64, any nesting) -> int64 tensor holding their
    uint64 bits."""
    arr = np.asarray(values, dtype=object)
    u = np.array([int(v) for v in arr.ravel()], dtype=np.uint64)
    u = u.reshape(arr.shape if shape is None else shape)
    return torch.from_numpy(u.view(np.int64).copy()).to(device)


class ModConsts(NamedTuple):
    """Per-prime constants of a tower of L moduli, each an int64 [L, 1]."""

    q: torch.Tensor        # modulus value
    two_q: torch.Tensor    # 2q (lazy-range bound)
    ratio0: torch.Tensor   # word 0 of floor(2^128/q)
    ratio1: torch.Tensor   # word 1 of floor(2^128/q)

    @property
    def count(self) -> int:
        return self.q.shape[0]

    def rows(self, index) -> "ModConsts":
        """Constants of the prime rows selected by a slice or index list."""
        return ModConsts(*(select_rows(a, index) for a in self))


def select_rows(a: torch.Tensor, index) -> torch.Tensor:
    """a[index] along dimension 0 for a slice or a list of row indices, as a
    contiguous tensor on a's device. Each run of consecutive indices is one
    slice, so no index tensor is copied from the host (a copy that a CUDA
    graph capture refuses)."""
    if isinstance(index, slice):
        return a[index].contiguous()
    runs: list[list[int]] = []
    for i in index:
        if runs and runs[-1][1] == i:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    return torch.cat([a[start:stop] for start, stop in runs])


def make_mod_consts(moduli, device) -> ModConsts:
    qs = [int(m) for m in moduli]
    mask = (1 << 64) - 1
    ratios = [(1 << 128) // q for q in qs]
    shape = (len(qs), 1)
    return ModConsts(
        q=u64_tensor(qs, device, shape),
        two_q=u64_tensor([2 * q for q in qs], device, shape),
        ratio0=u64_tensor([r & mask for r in ratios], device, shape),
        ratio1=u64_tensor([(r >> 64) & mask for r in ratios], device, shape),
    )


def shoup_pair(values, moduli, device, shape=None):
    """(operand, quotient) int64 tensors for Shoup multiplication from
    nested lists of Python ints of one shape; quotient = floor(v·2^64/m)."""
    v = np.asarray(values, dtype=object)
    m = np.asarray(moduli, dtype=object)
    quot = [(int(a) << 64) // int(b) for a, b in zip(v.ravel(), m.ravel())]
    shape = v.shape if shape is None else shape
    return u64_tensor(v, device, shape), u64_tensor(quot, device, shape)


# ---------------------------------------------------------------------------
# Coefficient-wise polynomial ops (parity: util/polyarithsmallmod.h)
# ---------------------------------------------------------------------------

def add_poly(a, b, mc: ModConsts):
    """(a + b) mod q, elementwise over [..., L, N]."""
    return modarith.add_mod(a, b, mc.q)


def sub_poly(a, b, mc: ModConsts):
    return modarith.sub_mod(a, b, mc.q)


def negate_poly(a, mc: ModConsts):
    return modarith.neg_mod(a, mc.q)


def dyadic_product(a, b, mc: ModConsts):
    """Elementwise NTT-domain product (dyadic_product_coeffmod parity)."""
    return modarith.mul_mod(a, b, mc.q, mc.ratio0, mc.ratio1)


def multiply_poly_scalar(a, scalar_op, scalar_quot, mc: ModConsts):
    """a · s mod q with s given as per-prime Shoup pairs of shape [L, 1]."""
    return modarith.mul_mod_shoup(a, scalar_op, scalar_quot, mc.q)


def modulo_poly_coeffs(a, mc: ModConsts):
    """Reduce arbitrary u64 coefficients into [0, q)."""
    return modarith.barrett_reduce_64(a, mc.q, mc.ratio1)


def negacyclic_shift_poly(a, shift: int, mc: ModConsts):
    """result[(i+shift) mod n] = ±a[i] in Z_q[x]/(x^n+1): a roll with the
    wrapped prefix negated, zero coefficients kept at zero
    (negacyclic_shift_poly_coeffmod, util/polyarithsmallmod.cpp:319-369)."""
    n = a.shape[-1]
    if not 0 <= shift < n:
        raise ValueError("shift must be in [0, n)")
    if shift == 0:
        return a
    rolled = torch.roll(a, shift, dims=-1)
    wrapped = torch.arange(n, device=a.device) < shift
    return torch.where(wrapped, modarith.neg_mod(rolled, mc.q), rolled)


def negacyclic_multiply_mono(a, coeff_op, coeff_quot, exponent: int, mc: ModConsts):
    """a · (c·x^e) mod (x^n+1, q): a Shoup scalar multiply, then a
    negacyclic shift; the same bits as NTT -> dyadic -> inverse NTT
    (negacyclic_multiply_poly_mono_coeffmod, util/polyarithsmallmod.h:634-655)."""
    return negacyclic_shift_poly(
        multiply_poly_scalar(a, coeff_op, coeff_quot, mc), exponent, mc)


def poly_infty_norm(a, mc: ModConsts):
    """max_i |a_i| with coefficients centred mod q, per prime row: values
    >= (q+1)/2 count as q - a_i (poly_infty_norm_coeffmod). Returns an int64
    tensor of shape [..., L, 1]."""
    absolute = torch.where(a >= (mc.q + 1) >> 1, mc.q - a, a)
    return absolute.amax(dim=-1, keepdim=True)
