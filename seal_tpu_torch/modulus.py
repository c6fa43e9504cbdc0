"""Modulus type and the coefficient-modulus factory.

The port's own copy of the parts of seal_tpu/modulus.py that the CKKS slice
needs: seal::Modulus, CoeffModulus::MaxBitCount and
CoeffModulus::Create (SEAL modulus.h:424-537). Values are exact Python ints;
the context layer ships them to the device as int64 tensors.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from seal_tpu_torch.utils import hestdparms, numth

MOD_BIT_COUNT_MAX = 61
USER_MOD_BIT_COUNT_MAX = 60
USER_MOD_BIT_COUNT_MIN = 2
COEFF_MOD_COUNT_MAX = 64
COEFF_MOD_COUNT_MIN = 1
POLY_MOD_DEGREE_MAX = 131072
POLY_MOD_DEGREE_MIN = 2
CIPHERTEXT_SIZE_MAX = 16


class SecLevelType(enum.IntEnum):
    """Security level per HomomorphicEncryption.org standard."""

    NONE = 0
    TC128 = 128
    TC192 = 192
    TC256 = 256


@dataclass(frozen=True)
class Modulus:
    """An up-to-61-bit modulus (SEAL modulus.h)."""

    value: int

    def __post_init__(self):
        v = self.value
        if v != 0 and (v.bit_length() > MOD_BIT_COUNT_MAX or v < 2):
            raise ValueError(f"modulus value {v} out of range")

    def __int__(self) -> int:
        return self.value

    def __eq__(self, other) -> bool:
        if isinstance(other, Modulus):
            return self.value == other.value
        if isinstance(other, int):
            return self.value == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.value)

    def __repr__(self) -> str:
        return f"Modulus({self.value:#x})"


class CoeffModulus:
    """Factory for coefficient-modulus prime chains."""

    @staticmethod
    def max_bit_count(poly_modulus_degree: int,
                      sec_level: SecLevelType = SecLevelType.TC128) -> int:
        if sec_level == SecLevelType.NONE:
            return COEFF_MOD_COUNT_MAX * MOD_BIT_COUNT_MAX
        return hestdparms.max_bit_count(poly_modulus_degree, int(sec_level))

    @staticmethod
    def create(poly_modulus_degree: int, bit_sizes: list[int]) -> list[Modulus]:
        """Distinct NTT-friendly primes, one per requested bit size, in the
        reference's assignment order (modulus.cpp:143-229): per distinct bit
        size, the largest `count` primes ≡ 1 (mod 2n), handed out to the
        bit_sizes positions smallest-first."""
        if (poly_modulus_degree > POLY_MOD_DEGREE_MAX
                or poly_modulus_degree < POLY_MOD_DEGREE_MIN
                or numth.get_power_of_two(poly_modulus_degree) < 0):
            raise ValueError("poly_modulus_degree is invalid")
        if len(bit_sizes) > COEFF_MOD_COUNT_MAX or not bit_sizes:
            raise ValueError("bit_sizes is invalid")
        if (max(bit_sizes) > USER_MOD_BIT_COUNT_MAX
                or min(bit_sizes) < USER_MOD_BIT_COUNT_MIN):
            raise ValueError("bit_sizes is invalid")
        factor = 2 * poly_modulus_degree
        count_table: dict[int, int] = {}
        for size in bit_sizes:
            count_table[size] = count_table.get(size, 0) + 1
        prime_table = {size: numth.get_primes(factor, size, count)
                       for size, count in count_table.items()}
        return [Modulus(prime_table[size].pop()) for size in bit_sizes]
