"""The key-switch inner product: the plain PyTorch version and the wrapper
of the CUDA kernel K2 (csrc/keyswitch.cu).

The port of seal_tpu/ops/keyswitch_pallas.py keyswitch_inner_pallas. For a
decomposed target t [J, I, N] and one kswitch key gathered to the extended
tower k [J, 2, I, N]:

    out[c, i, :] = (Σ_j t[j, i, :] · k[j, c, i, :]) mod q_i

with a 128-bit lazy sum and one Barrett-128 reduction (SEAL
evaluator.cpp:2517-2547). `keyswitch_inner` dispatches on the tensor's
device: a CPU tensor goes to the plain version, a CUDA tensor to the kernel
(or raises).
"""

from __future__ import annotations

import ctypes

import torch

from seal_tpu_torch import cuda
from seal_tpu_torch.ops import modarith
from seal_tpu_torch.ops.modring import u64_tensor

# With inputs below 2^61 the sum of J products fits 128 bits for J <= 64.
MAX_TERMS = 64


def pack_mod_consts(moduli, device) -> torch.Tensor:
    """int64 [I, 3] rows (q, ratio0, ratio1): the Barrett-128 constants
    floor(2^128/q) = ratio1·2^64 + ratio0 of each extended prime."""
    mask = (1 << 64) - 1
    rows = [[q, ((1 << 128) // q) & mask, (1 << 128) // q >> 64]
            for q in (int(m) for m in moduli)]
    return u64_tensor(rows, device, (len(rows), 3))


def _check(t_op, keys, consts):
    if t_op.dim() != 3 or keys.dim() != 4:
        raise ValueError("keyswitch_inner takes t [J, I, N] and keys [J, 2, I, N]")
    J, I, n = t_op.shape
    if tuple(keys.shape) != (J, 2, I, n) or tuple(consts.shape) != (I, 3):
        raise ValueError(
            f"shapes t {tuple(t_op.shape)}, keys {tuple(keys.shape)}, "
            f"consts {tuple(consts.shape)} do not agree")
    if not 1 <= J <= MAX_TERMS:
        raise ValueError(f"J = {J}: the 128-bit sum holds 1 to {MAX_TERMS} terms")
    for a in (t_op, keys, consts):
        if a.dtype != torch.int64:
            raise TypeError(f"keyswitch_inner takes int64, got {a.dtype}")
        if a.device != t_op.device:
            raise ValueError("keyswitch_inner inputs lie on different devices")
    return J, I, n


def keyswitch_inner_plain(t_op, keys, consts):
    _check(t_op, keys, consts)
    q, r0, r1 = (consts[:, k:k + 1] for k in range(3))     # [I, 1]
    out = []
    for c in range(2):
        acc = (torch.zeros_like(t_op[0]), torch.zeros_like(t_op[0]))
        for j in range(t_op.shape[0]):
            acc = modarith.mul_add_128(acc, t_op[j], keys[j, c])
        out.append(modarith.barrett_reduce_128(acc[0], acc[1], q, r0, r1))
    return torch.stack(out)


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"sealtorch_keyswitch_inner": [_P, _P, _P, _P, _I, _I, _I, _P]}


def keyswitch_inner_cuda(t_op, keys, consts):
    J, I, n = _check(t_op, keys, consts)
    if t_op.device.type != "cuda":
        raise ValueError(f"the key-switch kernel needs CUDA tensors, got {t_op.device}")
    if not (t_op.is_contiguous() and keys.is_contiguous() and consts.is_contiguous()):
        raise ValueError("the key-switch kernel needs contiguous inputs")
    if n & (n - 1):
        raise ValueError(f"N = {n} is not a power of two")
    lib = cuda.library("keyswitch", _SIGNATURES)
    out = torch.empty((2, I, n), dtype=torch.int64, device=t_op.device)
    cuda.check(lib.sealtorch_keyswitch_inner(
        t_op.data_ptr(), keys.data_ptr(), consts.data_ptr(), out.data_ptr(),
        J, I, n.bit_length() - 1, cuda.stream_ptr(t_op)), "keyswitch_inner kernel")
    cuda.launches["keyswitch_inner"] += 1
    return out


def keyswitch_inner(t_op, keys, consts):
    """out [2, I, N] fully reduced to [0, q_i); inputs below 2^61."""
    if t_op.device.type == "cuda":
        return keyswitch_inner_cuda(
            t_op.contiguous(), keys.contiguous(), consts.contiguous())
    return keyswitch_inner_plain(t_op, keys, consts)
