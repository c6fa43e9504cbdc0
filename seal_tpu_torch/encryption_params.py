"""Encryption parameters with SEAL-compatible parms_id hashing.

The port's own copy of seal_tpu/encryption_params.py without the PRNG
selection (the port draws from an explicit torch.Generator). The parms_id is
the blake2b-256 hash over the little-endian uint64 words [scheme,
poly_modulus_degree, coeff_modulus..., plain_modulus]
(SEAL encryptionparams.cpp:124-158), so a seal_tpu or SEAL parms_id carries
over unchanged.
"""

from __future__ import annotations

import enum
import hashlib
import struct

from seal_tpu_torch.modulus import Modulus

ParmsId = tuple  # 4-tuple of uint64


class SchemeType(enum.IntEnum):
    NONE = 0
    BFV = 1
    CKKS = 2
    BGV = 3


PARMS_ID_ZERO: ParmsId = (0, 0, 0, 0)


def _hash_u64_words(words) -> ParmsId:
    """blake2b-256 over little-endian u64 words -> 4 u64 words
    (SEAL util/hash.h HashFunction::hash)."""
    data = struct.pack(f"<{len(words)}Q", *words)
    digest = hashlib.blake2b(data, digest_size=32).digest()
    return tuple(struct.unpack("<4Q", digest))


class EncryptionParameters:
    """Scheme + degree + moduli; parms_id recomputed on every mutation."""

    def __init__(self, scheme: SchemeType | int = SchemeType.NONE):
        self._scheme = SchemeType(scheme)
        self._poly_modulus_degree = 0
        self._coeff_modulus: list[Modulus] = []
        self._plain_modulus = Modulus(0)
        self._special_modulus_size = 1
        self._compute_parms_id()

    def set_poly_modulus_degree(self, degree: int):
        if self._scheme == SchemeType.NONE and degree != 0:
            raise ValueError("poly_modulus_degree is not supported for this scheme")
        self._poly_modulus_degree = int(degree)
        self._compute_parms_id()

    def set_coeff_modulus(self, coeff_modulus):
        if self._scheme == SchemeType.NONE and coeff_modulus:
            raise ValueError("coeff_modulus is not supported for this scheme")
        if len(coeff_modulus) > 64:
            raise ValueError("coeff_modulus is invalid")
        self._coeff_modulus = [
            m if isinstance(m, Modulus) else Modulus(int(m)) for m in coeff_modulus]
        self._compute_parms_id()

    def set_special_modulus_size(self, alpha: int):
        """Number of special (key-switching-only) primes at the tail of
        coeff_modulus. 1 is SEAL's scheme (one special prime, per-prime
        decomposition, bit-exact to SEAL); α > 1 is hybrid key switching with
        ⌈L/α⌉ digits. Like seal_tpu, α is not part of parms_id."""
        alpha = int(alpha)
        if alpha < 1:
            raise ValueError("special_modulus_size must be >= 1")
        self._special_modulus_size = alpha

    @property
    def scheme(self) -> SchemeType:
        return self._scheme

    @property
    def poly_modulus_degree(self) -> int:
        return self._poly_modulus_degree

    @property
    def coeff_modulus(self) -> list[Modulus]:
        return list(self._coeff_modulus)

    @property
    def plain_modulus(self) -> Modulus:
        return self._plain_modulus

    @property
    def special_modulus_size(self) -> int:
        return self._special_modulus_size

    @property
    def parms_id(self) -> ParmsId:
        return self._parms_id

    def _compute_parms_id(self):
        words = [int(self._scheme), self._poly_modulus_degree]
        words.extend(m.value for m in self._coeff_modulus)
        words.append(self._plain_modulus.value)
        self._parms_id = _hash_u64_words(words)
        if self._parms_id == PARMS_ID_ZERO:
            raise RuntimeError("parms_id cannot be zero")

    def clone(self) -> "EncryptionParameters":
        p = EncryptionParameters(self._scheme)
        p._poly_modulus_degree = self._poly_modulus_degree
        p._coeff_modulus = list(self._coeff_modulus)
        p._plain_modulus = self._plain_modulus
        p._special_modulus_size = self._special_modulus_size
        p._compute_parms_id()
        return p

    def __repr__(self):
        return (
            f"EncryptionParameters(scheme={self._scheme.name}, "
            f"n={self._poly_modulus_degree}, "
            f"coeff_modulus={[hex(m.value) for m in self._coeff_modulus]}, "
            f"special_modulus_size={self._special_modulus_size})")
