"""Encryption parameters with SEAL-compatible parms_id hashing.

The port's own copy of seal_tpu/encryption_params.py. The parms_id is the
blake2b-256 hash over the little-endian uint64 words [scheme,
poly_modulus_degree, coeff_modulus..., plain_modulus]
(SEAL encryptionparams.cpp:124-158), so a seal_tpu or SEAL parms_id carries
over unchanged. The random seed and the PRNG type choose the byte stream
that keys and encryptions draw from (randomgen.py); like SEAL's PRNG
factory, neither is part of the parms_id.
"""

from __future__ import annotations

import enum
import hashlib
import struct

from seal_tpu_torch.modulus import Modulus
from seal_tpu_torch.randomgen import PrngType

ParmsId = tuple  # 4-tuple of uint64


class SchemeType(enum.IntEnum):
    NONE = 0
    BFV = 1
    CKKS = 2
    BGV = 3


PARMS_ID_ZERO: ParmsId = (0, 0, 0, 0)
parms_id_zero = PARMS_ID_ZERO


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
        self._random_seed = None     # 8 u64 words, or None for a fresh seed per stream
        self._prng_type = None       # None: blake2xb
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

    def set_plain_modulus(self, plain_modulus):
        """t, the plaintext modulus of BFV and BGV (an int or a Modulus)."""
        value = int(plain_modulus)
        if self._scheme not in (SchemeType.BFV, SchemeType.BGV) and value != 0:
            raise ValueError("plain_modulus is not supported for this scheme")
        self._plain_modulus = Modulus(value)
        self._compute_parms_id()

    def set_random_seed(self, seed):
        """Fix the seed (8 u64 words) of every stream that keys and
        encryptions draw from: SEAL's set_random_generator with a seeded
        factory, so each stream replays the same bytes. None or () goes
        back to a fresh seed per stream."""
        self._random_seed = (tuple(int(s) & ((1 << 64) - 1) for s in seed)
                             if seed else None)

    def set_prng_type(self, prng_type):
        """blake2xb (the default) or shake256 (SEAL's Shake256PRNGFactory);
        None goes back to the default."""
        self._prng_type = PrngType(prng_type) if prng_type is not None else None

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
    def random_seed(self):
        return self._random_seed

    @property
    def prng_type(self) -> PrngType:
        return PrngType.BLAKE2XB if self._prng_type is None else self._prng_type

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
        p._random_seed = self._random_seed
        p._prng_type = self._prng_type
        p._compute_parms_id()
        return p

    def __eq__(self, other):
        """Equal parms_id: scheme, n, coeff_modulus and plain_modulus (seed,
        prng type and α are not part of it, as in seal_tpu)."""
        return isinstance(other, EncryptionParameters) and self._parms_id == other._parms_id

    def __hash__(self):
        return hash(self._parms_id)

    def __repr__(self):
        return (
            f"EncryptionParameters(scheme={self._scheme.name}, "
            f"n={self._poly_modulus_degree}, "
            f"coeff_modulus={[hex(m.value) for m in self._coeff_modulus]}, "
            f"plain_modulus={self._plain_modulus.value}, "
            f"special_modulus_size={self._special_modulus_size})")
