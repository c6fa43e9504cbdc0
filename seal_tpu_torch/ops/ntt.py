"""Negacyclic NTT/INTT over RNS towers: host tables, the plain PyTorch
transforms, and the wrappers of the CUDA kernel K1 (csrc/ntt.cu).

The port of seal_tpu/ops/ntt.py. Parity-critical properties, kept exactly:

* the 2n-th root is the minimal primitive root, so transform values match
  SEAL bit for bit;
* forward tables hold ψ^i at index bitrev(i); inverse tables hold ψ^{-i} at
  index bitrev(i-1)+1 and are consumed sequentially per stage;
* n^{-1} is folded into the last inverse stage;
* lazy ranges: forward takes input < 4q and returns < q (< 4q when lazy);
  inverse takes input < 2q and returns < q (< 2q when lazy).

`ntt_forward` / `ntt_inverse` dispatch on the tensor's device: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel (or raises).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from seal_tpu_torch import cuda
from seal_tpu_torch.ops import modarith
from seal_tpu_torch.ops.modring import ModConsts, make_mod_consts, select_rows
from seal_tpu_torch.utils import numth

# ---------------------------------------------------------------------------
# Host tables (vectorised exact arithmetic, cached per prime)
# ---------------------------------------------------------------------------


def _bitrev(log_n: int) -> np.ndarray:
    i = np.arange(1 << log_n, dtype=np.int64)
    rev = np.zeros_like(i)
    for b in range(log_n):
        rev |= ((i >> b) & 1) << (log_n - 1 - b)
    return rev


def _powers(base: int, n: int, mc: ModConsts) -> torch.Tensor:
    """[base^0, ..., base^(n-1)] mod q by log-doubling with the exact
    Barrett multiply: powers[k:2k] = powers[:k] · base^k."""
    out = torch.ones(1, dtype=torch.int64)
    step = base
    while out.numel() < n:
        s = torch.tensor([step], dtype=torch.int64)
        out = torch.cat([out, modarith.mul_mod(
            out, s, mc.q[0], mc.ratio0[0], mc.ratio1[0])])
        step = step * step % int(mc.q[0, 0])
    return out[:n]


@functools.lru_cache(maxsize=None)
def build_ntt_tables(log_n: int, q: int):
    """Root tables of one prime as int64 numpy arrays: (fwd_op, fwd_qt,
    inv_op, inv_qt) of length n, then the Shoup pairs of n^{-1} and of
    inv_root_powers[n-1]·n^{-1} as Python ints. Value-identical to the
    Python-int loop of seal_tpu.ops.ntt.build_ntt_tables (pinned by
    tests/test_torch_ntt.py), without its per-element loop."""
    n = 1 << log_n
    root = numth.try_minimal_primitive_root(2 * n, q)
    if root is None:
        raise ValueError(f"modulus {q:#x} does not support NTT of size {n}")
    inv_root = numth.invert_uint_mod(root, q)
    mc = make_mod_consts([q], "cpu")
    rev = torch.from_numpy(_bitrev(log_n))

    fwd = torch.empty(n, dtype=torch.int64)
    fwd[rev] = _powers(root, n, mc)
    inv = torch.empty(n, dtype=torch.int64)
    inv[0] = 1
    inv[rev[:n - 1] + 1] = _powers(inv_root, n, mc)[1:]

    def quot(t):
        return modarith.shoup_quotient(t, mc.q[0], mc.ratio0[0], mc.ratio1[0])

    inv_degree = numth.invert_uint_mod(n, q)
    last = int(inv[n - 1]) * inv_degree % q
    return (fwd.numpy(), quot(fwd).numpy(), inv.numpy(), quot(inv).numpy(),
            (inv_degree, (inv_degree << 64) // q), (last, (last << 64) // q))


class NTTTables(NamedTuple):
    """Tables for a tower of L primes on one device: root tables [L, n],
    scalar Shoup pairs [L, 1]."""

    log_n: int
    mc: ModConsts
    fwd_op: torch.Tensor
    fwd_qt: torch.Tensor
    inv_op: torch.Tensor
    inv_qt: torch.Tensor
    inv_n_op: torch.Tensor     # n^{-1}
    inv_n_qt: torch.Tensor
    last_op: torch.Tensor      # inv_root_powers[n-1] · n^{-1}
    last_qt: torch.Tensor

    @property
    def count(self) -> int:
        return self.mc.count

    def rows(self, index) -> "NTTTables":
        """Tables of the prime rows selected by a slice or index list, as
        contiguous tensors (the kernel reads them by pointer)."""
        return NTTTables(self.log_n, self.mc.rows(index),
                         *(select_rows(a, index) for a in self[2:]))


def make_ntt_tables(log_n: int, moduli, device) -> NTTTables:
    qs = [int(m) for m in moduli]
    hosts = [build_ntt_tables(log_n, q) for q in qs]

    def stack(k):
        return torch.from_numpy(np.stack([h[k] for h in hosts])).to(device)

    def scalars(k, w):
        vals = np.array([h[k][w] for h in hosts], dtype=np.uint64)
        return torch.from_numpy(vals.view(np.int64).reshape(-1, 1)).to(device)

    return NTTTables(
        log_n, make_mod_consts(qs, device),
        stack(0), stack(1), stack(2), stack(3),
        scalars(4, 0), scalars(4, 1), scalars(5, 0), scalars(5, 1))


# ---------------------------------------------------------------------------
# Plain PyTorch transforms (stage by stage, like seal_tpu's XLA route)
# ---------------------------------------------------------------------------

def _guard(x, bound):
    return torch.where(x >= bound, x - bound, x)


def _check(x: torch.Tensor, t: NTTTables):
    if x.dtype != torch.int64:
        raise TypeError(f"NTT input must be int64, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != 1 << t.log_n or x.shape[-2] != t.count:
        raise ValueError(
            f"NTT input shape {tuple(x.shape)} does not match tables "
            f"[..., {t.count}, {1 << t.log_n}]")
    if x.device != t.fwd_op.device:
        raise ValueError(f"input on {x.device}, tables on {t.fwd_op.device}")


def ntt_forward_plain(x, t: NTTTables, lazy: bool = False):
    _check(x, t)
    n = 1 << t.log_n
    q3 = t.mc.q[:, :, None]
    two_q3 = t.mc.two_q[:, :, None]
    for s in range(t.log_n):
        m, gap = 1 << s, n >> (s + 1)
        v = x.reshape(x.shape[:-1] + (m, 2, gap))
        w = t.fwd_op[:, m:2 * m, None]              # [L, m, 1]
        wq = t.fwd_qt[:, m:2 * m, None]
        u = _guard(v[..., 0, :], two_q3)
        p = modarith.mul_mod_shoup_lazy(v[..., 1, :], w, wq, q3)
        x = torch.stack([u + p, u + two_q3 - p], dim=-2).reshape(x.shape)
    if not lazy:
        x = modarith.cond_sub(_guard(x, t.mc.two_q), t.mc.q)
    return x


def ntt_inverse_plain(x, t: NTTTables, lazy: bool = False):
    _check(x, t)
    n = 1 << t.log_n
    q3 = t.mc.q[:, :, None]
    two_q3 = t.mc.two_q[:, :, None]
    offset = 1
    for s in range(t.log_n - 1, 0, -1):
        m, gap = 1 << s, n >> (s + 1)
        v = x.reshape(x.shape[:-1] + (m, 2, gap))
        u, w_in = v[..., 0, :], v[..., 1, :]
        w = t.inv_op[:, offset:offset + m, None]
        wq = t.inv_qt[:, offset:offset + m, None]
        offset += m
        y0 = _guard(u + w_in, two_q3)
        y1 = modarith.mul_mod_shoup_lazy(u + two_q3 - w_in, w, wq, q3)
        x = torch.stack([y0, y1], dim=-2).reshape(x.shape)
    # last stage (m=1, gap=n/2), n^{-1} folded into both outputs
    q, two_q = t.mc.q, t.mc.two_q
    u = _guard(x[..., : n // 2], two_q)
    v = x[..., n // 2:]
    y0 = modarith.mul_mod_shoup_lazy(
        _guard(u + v, two_q), t.inv_n_op, t.inv_n_qt, q)
    y1 = modarith.mul_mod_shoup_lazy(u + two_q - v, t.last_op, t.last_qt, q)
    x = torch.cat([y0, y1], dim=-1)
    if not lazy:
        x = modarith.cond_sub(x, q)
    return x


# ---------------------------------------------------------------------------
# K1 wrappers (csrc/ntt.cu): every n from 2 to 131072, one or two kernel
# launches per transform, counted once
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sealtorch_ntt_forward": [_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I,
                              _I, _P],
    "sealtorch_ntt_inverse": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                              ctypes.c_longlong, _I, _I, _I, _P],
}


def _check_cuda(x: torch.Tensor, t: NTTTables):
    _check(x, t)
    if x.device.type != "cuda":
        raise ValueError(f"the NTT kernel needs a CUDA tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("the NTT kernel needs a contiguous input")
    return cuda.library("ntt", _SIGNATURES)


def ntt_forward_cuda(x, t: NTTTables, lazy: bool = False):
    lib = _check_cuda(x, t)
    out = torch.empty_like(x)
    rows = x.numel() >> t.log_n
    if rows:
        cuda.check(lib.sealtorch_ntt_forward(
            x.data_ptr(), out.data_ptr(), t.fwd_op.data_ptr(),
            t.fwd_qt.data_ptr(), t.mc.q.data_ptr(), rows, t.count, t.log_n,
            int(lazy), cuda.stream_ptr(x)), "ntt_forward kernel")
        cuda.launches["ntt_forward"] += 1
    return out


def ntt_inverse_cuda(x, t: NTTTables, lazy: bool = False):
    lib = _check_cuda(x, t)
    out = torch.empty_like(x)
    rows = x.numel() >> t.log_n
    if rows:
        cuda.check(lib.sealtorch_ntt_inverse(
            x.data_ptr(), out.data_ptr(), t.inv_op.data_ptr(),
            t.inv_qt.data_ptr(), t.mc.q.data_ptr(), t.inv_n_op.data_ptr(),
            t.inv_n_qt.data_ptr(), t.last_op.data_ptr(), t.last_qt.data_ptr(),
            rows, t.count, t.log_n, int(lazy), cuda.stream_ptr(x)),
            "ntt_inverse kernel")
        cuda.launches["ntt_inverse"] += 1
    return out


def ntt_forward(x, t: NTTTables, lazy: bool = False):
    """Negacyclic NTT of x [..., L, N]: natural order in (< 4q), bit-reversed
    order out, < q (< 4q when lazy)."""
    if x.device.type == "cuda":
        return ntt_forward_cuda(x.contiguous(), t, lazy)
    return ntt_forward_plain(x, t, lazy)


def ntt_inverse(x, t: NTTTables, lazy: bool = False):
    """Inverse negacyclic NTT of x [..., L, N]: bit-reversed order in
    (< 2q), natural order out, < q (< 2q when lazy)."""
    if x.device.type == "cuda":
        return ntt_inverse_cuda(x.contiguous(), t, lazy)
    return ntt_inverse_plain(x, t, lazy)
