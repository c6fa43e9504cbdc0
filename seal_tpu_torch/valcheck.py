"""Validity checks of the port's objects against a context.

The port of seal_tpu/valcheck.py (SEAL valcheck.{h,cpp}:31-162), in three
layers: metadata (the parms_id is in the chain, the sizes fit it), buffer
(the tensor is there, with the right rank) and data (every residue of row
i satisfies 0 <= x < q_i), together is_valid_for. The data check runs on
the tensor's device and reads one boolean back: an int64 residue below 0
is a uint64 of 2^63 or more, which no modulus admits. serialization.py
checks every ciphertext and key it loads this way.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.context import SEALContext
from seal_tpu_torch.dtypes import Ciphertext, KSwitchKeys, Plaintext, PublicKey, SecretKey
from seal_tpu_torch.encryption_params import SchemeType
from seal_tpu_torch.modulus import CIPHERTEXT_SIZE_MAX, CIPHERTEXT_SIZE_MIN


def _shape_is(t, shape) -> bool:
    return t is not None and tuple(t.shape) == tuple(shape)


def is_metadata_valid_for(obj, context: SEALContext, allow_pure_key_levels: bool = False) -> bool:
    if isinstance(obj, Ciphertext):
        cd = context.get_context_data(obj.parms_id)
        if cd is None:
            return False
        if (not allow_pure_key_levels and context.using_keyswitching
                and tuple(obj.parms_id) == tuple(context.key_parms_id)):
            return False
        if not CIPHERTEXT_SIZE_MIN <= obj.size <= CIPHERTEXT_SIZE_MAX:
            return False
        return (obj.coeff_modulus_size == cd.coeff_modulus_size
                and obj.poly_modulus_degree == cd.parms.poly_modulus_degree)
    if isinstance(obj, Plaintext):
        if obj.is_ntt_form:
            cd = context.get_context_data(obj.parms_id)
            return cd is not None and obj.data is not None and tuple(obj.data.shape[-2:]) == (
                cd.coeff_modulus_size, cd.parms.poly_modulus_degree)
        return obj.coeff_count <= context.first_context_data().parms.poly_modulus_degree
    if isinstance(obj, SecretKey):
        cd = context.key_context_data()
        return tuple(obj.parms_id) == tuple(context.key_parms_id) and _shape_is(
            obj.data, (cd.coeff_modulus_size, cd.parms.poly_modulus_degree))
    if isinstance(obj, PublicKey):
        return (obj.data is not None and tuple(obj.parms_id) == tuple(context.key_parms_id)
                and obj.data.is_ntt_form
                and is_metadata_valid_for(obj.data, context, allow_pure_key_levels=True))
    if isinstance(obj, KSwitchKeys):
        if tuple(obj.parms_id) != tuple(context.key_parms_id):
            return False
        key_cd = context.key_context_data()
        alpha = key_cd.parms.special_modulus_size
        digits = -(-context.first_context_data().coeff_modulus_size // alpha)
        shape = (digits, 2, key_cd.coeff_modulus_size, key_cd.parms.poly_modulus_degree)
        return all(k is None or _shape_is(k, shape) for k in obj.keys)
    raise TypeError(f"unsupported object type {type(obj)}")


def is_buffer_valid(obj) -> bool:
    if isinstance(obj, Ciphertext):
        return (obj.data is not None and obj.data.dim() >= 3
                and obj.data.dtype == torch.int64)
    if isinstance(obj, Plaintext):
        return obj.data is None and not obj.is_ntt_form or (
            obj.data is not None and obj.data.dtype == torch.int64)
    return True


def _rows_below(data: torch.Tensor, cd) -> torch.Tensor:
    """On data's device: every residue x of row i (the axis -2) has
    0 <= x < q_i, the primes of level cd."""
    q = cd.mod_consts.q.to(data.device)
    return ((data >= 0) & (data < q)).all()


def is_data_valid_for(obj, context: SEALContext) -> bool:
    """Every residue below its prime (a BFV/BGV plaintext's coefficients
    below t), checked on the object's device with one read back."""
    if isinstance(obj, Ciphertext):
        return bool(_rows_below(obj.data, context.get_context_data(obj.parms_id)))
    if isinstance(obj, Plaintext):
        if obj.data is None or obj.data.numel() == 0:
            return True
        if obj.is_ntt_form:
            return bool(_rows_below(obj.data, context.get_context_data(obj.parms_id)))
        parms = context.key_context_data().parms
        if parms.scheme in (SchemeType.BFV, SchemeType.BGV):
            t = parms.plain_modulus.value
            return bool(((obj.data >= 0) & (obj.data < t)).all())
        return True
    key_cd = context.key_context_data()
    if isinstance(obj, SecretKey):
        return bool(_rows_below(obj.data, key_cd))
    if isinstance(obj, PublicKey):
        return bool(_rows_below(obj.data.data, key_cd))
    if isinstance(obj, KSwitchKeys):
        present = [k for k in obj.keys if k is not None]
        if not present:
            return True
        ok = _rows_below(present[0], key_cd)
        for k in present[1:]:
            ok = ok & _rows_below(k, key_cd)
        return bool(ok)
    return True


def is_valid_for(obj, context: SEALContext) -> bool:
    """Metadata, buffer and data all valid (valcheck.h is_valid_for)."""
    return (is_metadata_valid_for(obj, context) and is_buffer_valid(obj)
            and is_data_valid_for(obj, context))
