"""Scheme data types: Plaintext, Ciphertext and keys.

The port of seal_tpu/dtypes.py. Each object holds one int64 tensor whose
words are the uint64 residues (seal_tpu holds a (lo, hi) pair of uint32
arrays): [L, N] for a plaintext or secret key, [size, L, N] for a
ciphertext, [d, 2, L_key, N] per key-switching key.
"""

from __future__ import annotations

import numpy as np
import torch

from seal_tpu_torch.encryption_params import PARMS_ID_ZERO, ParmsId


def u64_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor on any device -> uint64 numpy array of the same bits."""
    return t.detach().cpu().numpy().view(np.uint64)


class Plaintext:
    """A CKKS plaintext: an RNS poly [L, N] in NTT form with a scale."""

    def __init__(self, data: torch.Tensor | None = None,
                 parms_id: ParmsId = PARMS_ID_ZERO, scale: float = 1.0):
        self.data = data
        self.parms_id = parms_id
        self.scale = scale

    @property
    def is_ntt_form(self) -> bool:
        return self.parms_id != PARMS_ID_ZERO

    def to_numpy(self) -> np.ndarray:
        return u64_numpy(self.data)


class Ciphertext:
    """size >= 2 polynomials over the level's tower: [size, L, N]
    (SEAL ciphertext.h)."""

    def __init__(self, data: torch.Tensor | None = None,
                 parms_id: ParmsId = PARMS_ID_ZERO, is_ntt_form: bool = False,
                 scale: float = 1.0, correction_factor: int = 1):
        self.data = data
        self.parms_id = parms_id
        self.is_ntt_form = is_ntt_form
        self.scale = scale
        self.correction_factor = correction_factor

    @property
    def size(self) -> int:
        return 0 if self.data is None else self.data.shape[0]

    @property
    def coeff_modulus_size(self) -> int:
        return 0 if self.data is None else self.data.shape[1]

    @property
    def poly_modulus_degree(self) -> int:
        return 0 if self.data is None else self.data.shape[2]

    def poly(self, j: int) -> torch.Tensor:
        """The j-th polynomial, [L, N]."""
        return self.data[j]

    def to_numpy(self) -> np.ndarray:
        return u64_numpy(self.data)

    def copy(self) -> "Ciphertext":
        return Ciphertext(self.data, self.parms_id, self.is_ntt_form, self.scale,
                          self.correction_factor)

    def is_transparent(self) -> bool:
        """True when c1 and above are all zero: decryptable without the secret
        key (SEAL ciphertext.h is_transparent). Reads the device."""
        return self.size < 2 or not bool(self.data[1:].any())

    def __repr__(self):
        return (f"Ciphertext(size={self.size}, L={self.coeff_modulus_size}, "
                f"n={self.poly_modulus_degree}, ntt={self.is_ntt_form}, "
                f"scale={self.scale})")


class SecretKey:
    """NTT-form RNS poly at the key level: [L_key, N]."""

    def __init__(self, data: torch.Tensor | None = None,
                 parms_id: ParmsId = PARMS_ID_ZERO):
        self.data = data
        self.parms_id = parms_id

    def to_numpy(self) -> np.ndarray:
        return u64_numpy(self.data)


class KSwitchKeys:
    """keys[target] = [d, 2, L_key, N]: per decomposition digit, a size-2
    NTT-form encryption over the key-level tower (SEAL kswitchkeys.h)."""

    def __init__(self, keys=None, parms_id: ParmsId = PARMS_ID_ZERO):
        self.keys: list = list(keys or [])
        self.parms_id = parms_id

    @property
    def size(self) -> int:
        return len(self.keys)


class RelinKeys(KSwitchKeys):
    """Key-switching keys for s^2, s^3, ... (SEAL relinkeys.h)."""

    @staticmethod
    def get_index(key_power: int) -> int:
        if key_power < 2:
            raise ValueError("key_power cannot be less than 2")
        return key_power - 2

    def has_key(self, key_power: int) -> bool:
        i = self.get_index(key_power)
        return i < len(self.keys) and self.keys[i] is not None

    def key(self, key_power: int) -> torch.Tensor:
        return self.keys[self.get_index(key_power)]


class GaloisKeys(KSwitchKeys):
    """Key-switching keys indexed by Galois element: keys[(elt - 1) / 2],
    None where there is no key (SEAL galoiskeys.h)."""

    @staticmethod
    def get_index(galois_elt: int) -> int:
        if galois_elt < 3 or galois_elt % 2 == 0:
            raise ValueError("galois_elt is not valid")
        return (galois_elt - 1) >> 1

    def has_key(self, galois_elt: int) -> bool:
        i = self.get_index(galois_elt)
        return i < len(self.keys) and self.keys[i] is not None

    def key(self, galois_elt: int) -> torch.Tensor:
        return self.keys[self.get_index(galois_elt)]
