"""The key-switch inner product in two routes, each a plain PyTorch version
and the wrapper of a CUDA kernel in csrc/keyswitch.cu.

For a decomposed target t [J, I, N] and one kswitch key gathered to the
extended tower k [J, 2, I, N]:

    out[c, i, :] = (Σ_j t[j, i, :] · k[j, c, i, :]) mod q_i

A batch of targets t [*batch, J, I, N] that share the key gives out
[*batch, 2, I, N], each member the bits of its own call (the key stays
unbatched, as it does under bench.py's vmap). The kernels fetch each key
word from device memory about once per call: the blocks of all members
that read one range of the key run side by side and share it through L2.

* `keyswitch_inner` (kernel K2), the port of seal_tpu/ops/keyswitch_pallas.py
  keyswitch_inner_pallas: a 128-bit lazy sum and one Barrett-128 reduction
  (SEAL evaluator.cpp:2517-2547).
* `keyswitch_inner_shoup` (kernel K3), the port of
  keyswitch_inner_shoup_pallas: from the key's Shoup quotients
  floor(k·2^64/q) (`key_quotients`), each term is a lazy Shoup product below
  2q, the J terms are summed in 64 bits (valid while 2·J·max q < 2^64), and
  a chain of conditional subtractions of q·2^s brings the sum below q.

Both give the unique representative in [0, q), so the same bits. Each
dispatcher goes by the tensor's device: a CPU tensor to the plain version,
a CUDA tensor to the kernel (or raises).
"""

from __future__ import annotations

import ctypes
import math

import torch

from seal_tpu_torch import cuda
from seal_tpu_torch.ops import modarith
from seal_tpu_torch.ops.modring import make_mod_consts, u64_tensor

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
    """(batch shape, J, I, N) of t [*batch, J, I, N] against keys [J, 2, I, N]
    and consts [I, 3]."""
    if t_op.dim() < 3 or keys.dim() != 4:
        raise ValueError("keyswitch_inner takes t [*batch, J, I, N] and keys [J, 2, I, N]")
    J, I, n = t_op.shape[-3:]
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
    return tuple(t_op.shape[:-3]), J, I, n


def keyswitch_inner_plain(t_op, keys, consts):
    _check(t_op, keys, consts)
    q, r0, r1 = (consts[:, k:k + 1] for k in range(3))     # [I, 1]
    out = []
    for c in range(2):
        acc = (torch.zeros_like(t_op[..., 0, :, :]), torch.zeros_like(t_op[..., 0, :, :]))
        for j in range(t_op.shape[-3]):
            acc = modarith.mul_add_128(acc, t_op[..., j, :, :], keys[j, c])
        out.append(modarith.barrett_reduce_128(acc[0], acc[1], q, r0, r1))
    return torch.stack(out, dim=-3)


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"sealtorch_keyswitch_inner": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
               "sealtorch_keyswitch_inner_shoup": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]}


def _kernel_batch(t_op, others, n) -> int:
    """Check the operands for the kernel; returns B, the members of t's
    batch (1 for an unbatched t)."""
    if t_op.device.type != "cuda":
        raise ValueError(f"the key-switch kernel needs CUDA tensors, got {t_op.device}")
    if not all(a.is_contiguous() for a in (t_op, *others)):
        raise ValueError("the key-switch kernel needs contiguous inputs")
    if n & (n - 1):
        raise ValueError(f"N = {n} is not a power of two")
    B = math.prod(t_op.shape[:-3])
    if B < 1:
        raise ValueError("keyswitch_inner needs at least one target")
    return B


def keyswitch_inner_cuda(t_op, keys, consts):
    lead, J, I, n = _check(t_op, keys, consts)
    B = _kernel_batch(t_op, (keys, consts), n)
    lib = cuda.library("keyswitch", _SIGNATURES)
    out = torch.empty(lead + (2, I, n), dtype=torch.int64, device=t_op.device)
    cuda.check(lib.sealtorch_keyswitch_inner(
        t_op.data_ptr(), keys.data_ptr(), consts.data_ptr(), out.data_ptr(),
        B, J, I, n.bit_length() - 1, cuda.stream_ptr(t_op)), "keyswitch_inner kernel")
    cuda.launches["keyswitch_inner"] += 1
    return out


def keyswitch_inner(t_op, keys, consts):
    """out [*batch, 2, I, N] fully reduced to [0, q_i); inputs below 2^61."""
    if t_op.device.type == "cuda":
        return keyswitch_inner_cuda(
            t_op.contiguous(), keys.contiguous(), consts.contiguous())
    return keyswitch_inner_plain(t_op, keys, consts)


# ---------------------------------------------------------------------------
# The Shoup-quotient route (K3)
# ---------------------------------------------------------------------------

def key_quotients(keys, moduli) -> torch.Tensor:
    """floor(k·2^64/q_i) for every element of a kswitch key [d, 2, L_key, N]
    whose rows are the L_key key-level `moduli`, on the key's device (the
    port of seal_tpu/evaluator.py _key_quot_fn)."""
    mc = make_mod_consts(moduli, keys.device)
    return modarith.shoup_quotient(keys, mc.q, mc.ratio0, mc.ratio1)


def _check_shoup(t_op, keys, keys_quot, consts, max_q):
    lead, J, I, n = _check(t_op, keys, consts)
    if keys_quot.shape != keys.shape or keys_quot.dtype != torch.int64 \
            or keys_quot.device != t_op.device:
        raise ValueError(f"key quotients {tuple(keys_quot.shape)} {keys_quot.dtype} on "
                         f"{keys_quot.device} do not match the keys")
    if 2 * J * max_q >= 1 << 64:
        raise ValueError(f"J = {J}: the lazy Shoup sum needs 2·J·max q < 2^64")
    return lead, J, I, n


def keyswitch_inner_shoup_plain(t_op, keys, keys_quot, consts, max_q):
    _check_shoup(t_op, keys, keys_quot, consts, max_q)
    q = consts[:, :1]                                       # [I, 1]
    J = t_op.shape[-3]
    out = []
    for c in range(2):
        acc = None
        for j in range(J):
            term = modarith.mul_mod_shoup_lazy(t_op[..., j, :, :], keys[j, c],
                                               keys_quot[j, c], q)
            acc = term if acc is None else acc + term
        # the sum and q·2^s may pass 2^63: compare unsigned, as the kernel does
        for s in range((2 * J - 1).bit_length() - 1, -1, -1):
            acc = modarith.cond_sub_u64(acc, q << s)
        out.append(acc)
    return torch.stack(out, dim=-3)


def keyswitch_inner_shoup_cuda(t_op, keys, keys_quot, consts, max_q):
    lead, J, I, n = _check_shoup(t_op, keys, keys_quot, consts, max_q)
    B = _kernel_batch(t_op, (keys, keys_quot, consts), n)
    lib = cuda.library("keyswitch", _SIGNATURES)
    out = torch.empty(lead + (2, I, n), dtype=torch.int64, device=t_op.device)
    cuda.check(lib.sealtorch_keyswitch_inner_shoup(
        t_op.data_ptr(), keys.data_ptr(), keys_quot.data_ptr(), consts.data_ptr(),
        out.data_ptr(), B, J, I, n.bit_length() - 1, cuda.stream_ptr(t_op)),
        "keyswitch_inner_shoup kernel")
    cuda.launches["keyswitch_inner_shoup"] += 1
    return out


def keyswitch_inner_shoup(t_op, keys, keys_quot, consts, max_q: int):
    """out [*batch, 2, I, N] fully reduced to [0, q_i), the same bits as
    keyswitch_inner; t below 2^64, keys below q with their quotients.
    max_q is the largest modulus of consts as a host int (reading it from a
    CUDA tensor would wait for the card); the call is refused unless
    2·J·max_q < 2^64."""
    if t_op.device.type == "cuda":
        return keyswitch_inner_shoup_cuda(
            t_op.contiguous(), keys.contiguous(), keys_quot.contiguous(),
            consts.contiguous(), max_q)
    return keyswitch_inner_shoup_plain(t_op, keys, keys_quot, consts, max_q)
