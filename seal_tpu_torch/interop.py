"""Carry keys and ciphertexts into the port from uint64 numpy arrays and
their metadata.

A seal_tpu object exports to exactly these arrays (Ciphertext.to_numpy(),
a BFV/BGV Plaintext's data, dtypes.to_host of RelinKeys.keys[i], of
GaloisKeys.keys[i] and of a SecretKey's data), as do
SEAL's own vectors; this module reads them without
importing seal_tpu. The port draws from SEAL's own byte stream, so from
the same random seed it makes the same keys and ciphertexts itself; this
module carries state that was made elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from seal_tpu_torch.context import SEALContext
from seal_tpu_torch.dtypes import (
    Ciphertext, GaloisKeys, Plaintext, PublicKey, RelinKeys, SecretKey)


def u64_to_tensor(arr, context: SEALContext) -> torch.Tensor:
    """uint64 numpy array -> int64 tensor of the same bits on the context's
    device."""
    a = np.ascontiguousarray(arr, dtype=np.uint64)
    return torch.from_numpy(a.view(np.int64).copy()).to(context.device)


def ciphertext_from_numpy(context: SEALContext, data, parms_id, scale: float,
                          is_ntt_form: bool = True,
                          correction_factor: int = 1) -> Ciphertext:
    """data: uint64 [size, L, N], or [*batch, size, L, N] for a batch."""
    t = u64_to_tensor(data, context)
    if t.dim() < 3:
        raise ValueError(f"ciphertext data must be [*batch, size, L, N], got {tuple(t.shape)}")
    return Ciphertext(t, tuple(int(w) for w in parms_id), is_ntt_form,
                      float(scale), int(correction_factor))


def plaintext_from_numpy(context: SEALContext, data) -> Plaintext:
    """data: uint64 [<= N], the coefficients mod t of a BFV/BGV plaintext."""
    return Plaintext(u64_to_tensor(data, context).reshape(-1))


def secret_key_from_numpy(context: SEALContext, data) -> SecretKey:
    """data: uint64 [L_key, N], the NTT-form secret key at the key level."""
    return SecretKey(u64_to_tensor(data, context), tuple(context.key_parms_id))


def public_key_from_numpy(context: SEALContext, data) -> PublicKey:
    """data: uint64 [2, L_key, N], the NTT-form public key."""
    return PublicKey(ciphertext_from_numpy(context, data, context.key_parms_id, 1.0))


def relin_keys_from_numpy(context: SEALContext, keys) -> RelinKeys:
    """keys: one uint64 [d, 2, L_key, N] array per key power 2, 3, ..."""
    return RelinKeys([u64_to_tensor(k, context) for k in keys],
                     tuple(context.key_parms_id))


def galois_keys_from_numpy(context: SEALContext, keys) -> GaloisKeys:
    """keys: per index (elt - 1) / 2, one uint64 [d, 2, L_key, N] array or
    None where there is no key."""
    return GaloisKeys([None if k is None else u64_to_tensor(k, context) for k in keys],
                      tuple(context.key_parms_id))
