"""Modular arithmetic on int64 tensors that hold unsigned 64-bit words.

The port of seal_tpu/ops/limb.py. seal_tpu keeps every 64-bit value as a
(lo, hi) pair of uint32 arrays because the TPU has no 64-bit multiply; the
port keeps one int64 tensor and reads its bits as a uint64 (CUDA kernels
reinterpret the same memory as uint64_t). The algorithms are limb.py's, so
results are bit-identical to seal_tpu and to SEAL's uintarithsmallmod.h.

Conventions
-----------
* Moduli are below 2^60, so residues and every lazy range on the CKKS path
  (at most 5q) stay below 2^63: ordinary signed comparisons are exact for
  them. The Shoup key switch's lazy sum may reach 2^64 and is reduced with
  the unsigned `cond_sub_u64`. Words that use all 64 bits (Shoup
  quotients, Barrett ratios, the halves of a 128-bit product) are negative
  as int64 and only ever pass through wrapping +, -, * and the bit
  operations below.
* `>>` on int64 is an arithmetic shift, so every 32-bit split masks with
  `& 0xFFFFFFFF` after shifting.
* int64 `*` and `+` wrap modulo 2^64 on both the CPU and CUDA, which is the
  uint64 arithmetic the algorithms need.
* All functions broadcast: per-prime constants of shape [L, 1] combine with
  coefficient tensors of shape [..., L, N].
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _hi32(x):
    return (x >> 32) & M32


def mul_wide(a, b):
    """Full 128-bit product of two u64 words -> (lo, hi) u64 words, formed
    from four 32x32-bit partial products."""
    a0, a1 = a & M32, _hi32(a)
    b0, b1 = b & M32, _hi32(b)
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = _hi32(ll) + (lh & M32) + (hl & M32)   # < 3·2^32
    lo = (ll & M32) | ((mid & M32) << 32)
    hi = hh + _hi32(lh) + _hi32(hl) + (mid >> 32)
    return lo, hi


def mulhi(a, b):
    """High 64 bits of the 128-bit product (multiply_uint64_hw64)."""
    return mul_wide(a, b)[1]


def add_carry(a, b):
    """u64 a + b -> (sum mod 2^64, carry-out in {0, 1})."""
    s = a + b
    carry = (((a & b) | ((a | b) & ~s)) >> 63) & 1
    return s, carry


def cond_sub(a, q):
    """a - q if a >= q else a (one correction step; a < 2^63)."""
    return torch.where(a >= q, a - q, a)


_SIGN = -(1 << 63)


def cond_sub_u64(a, q):
    """a - q if a >= q, comparing as unsigned 64-bit words: for sums and
    multiples of q that may pass 2^63 (flipping the sign bit maps unsigned
    order onto signed order)."""
    return torch.where((a ^ _SIGN) >= (q ^ _SIGN), a - q, a)


def add_mod(a, b, q):
    """(a + b) mod q for a, b < q."""
    return cond_sub(a + b, q)


def sub_mod(a, b, q):
    """(a - b) mod q for a, b < q."""
    return cond_sub(a + q - b, q)


def neg_mod(a, q):
    """(-a) mod q for a < q: q - a, with 0 kept at 0."""
    return torch.where(a != 0, q - a, torch.zeros_like(a))


def barrett_reduce_64(x, q, ratio1):
    """x mod q for any u64 x (SEAL uintarithsmallmod.h:211-230)."""
    approx = mulhi(x, ratio1)
    return cond_sub(x - approx * q, q)          # x - approx·q < 2q


def barrett_reduce_128(x_lo, x_hi, q, ratio0, ratio1):
    """(x_hi·2^64 + x_lo) mod q (SEAL uintarithsmallmod.h:167-209):
    quot = floor((x_lo·r0/2^64 + x_lo·r1 + x_hi·r0)/2^64) + x_hi·r1,
    result = x_lo - quot·q, then one conditional subtraction."""
    carry = mulhi(x_lo, ratio0)
    t_lo, t_hi = mul_wide(x_lo, ratio1)
    tmp1, c = add_carry(t_lo, carry)
    tmp3 = t_hi + c
    u_lo, u_hi = mul_wide(x_hi, ratio0)
    _, c = add_carry(tmp1, u_lo)
    carry2 = u_hi + c
    quot = x_hi * ratio1 + tmp3 + carry2
    return cond_sub(x_lo - quot * q, q)


def mul_mod(a, b, q, ratio0, ratio1):
    """(a * b) mod q via the full product and Barrett-128."""
    lo, hi = mul_wide(a, b)
    return barrett_reduce_128(lo, hi, q, ratio0, ratio1)


def mul_mod_shoup_lazy(x, y, y_quot, q):
    """x·y mod q in [0, 2q) for y < q with its Shoup quotient
    floor(y·2^64/q); x may be any u64 (SEAL multiply_uint_mod_lazy)."""
    return x * y - mulhi(x, y_quot) * q


def mul_mod_shoup(x, y, y_quot, q):
    """x·y mod q, fully reduced (SEAL uintarithsmallmod.h:292-311)."""
    return cond_sub(mul_mod_shoup_lazy(x, y, y_quot, q), q)


def shoup_quotient(y, q, ratio0, ratio1):
    """floor(y·2^64 / q) for y < q, from the Barrett constants (limb.py
    shoup_quotient): est = floor(y·ratio/2^64) is at most one below the
    quotient; two guarded corrections make it exact."""
    est = y * ratio1 + mulhi(y, ratio0)
    rem = -(est * q)                            # y·2^64 - est·q, < 2q
    for _ in range(2):
        ge = rem >= q
        rem = torch.where(ge, rem - q, rem)
        est = torch.where(ge, est + 1, est)
    return est


def mul_add_128(acc, a, b):
    """acc += a·b for a 128-bit accumulator acc = (lo, hi)."""
    p_lo, p_hi = mul_wide(a, b)
    lo, c = add_carry(acc[0], p_lo)
    return lo, acc[1] + p_hi + c
