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
        if not isinstance(index, slice):
            index = torch.as_tensor(index, device=self.q.device)
        return ModConsts(*(a[index].contiguous() for a in self))


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
