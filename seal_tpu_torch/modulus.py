"""Modulus type and the coefficient-modulus factory.

The port's own copy of seal_tpu/modulus.py: seal::Modulus,
CoeffModulus::MaxBitCount, BFVDefault and Create, and PlainModulus::Batching
(SEAL modulus.h:424-559). Values are exact Python ints; the context layer
ships them to the device as int64 tensors.
"""

from __future__ import annotations

import enum
import functools
from dataclasses import dataclass

from seal_tpu_torch.utils import hestdparms, numth

MOD_BIT_COUNT_MAX = 61
MOD_BIT_COUNT_MIN = 2
USER_MOD_BIT_COUNT_MAX = 60
USER_MOD_BIT_COUNT_MIN = 2
INTERNAL_MOD_BIT_COUNT = 61     # the BEHZ auxiliary primes (Bsk, m_sk, γ)
COEFF_MOD_COUNT_MAX = 64
COEFF_MOD_COUNT_MIN = 1
POLY_MOD_DEGREE_MAX = 131072
POLY_MOD_DEGREE_MIN = 2
CIPHERTEXT_SIZE_MIN = 2
CIPHERTEXT_SIZE_MAX = 16


class SecLevelType(enum.IntEnum):
    """Security level per HomomorphicEncryption.org standard."""

    NONE = 0
    TC128 = 128
    TC192 = 192
    TC256 = 256


@functools.total_ordering
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

    def reduce(self, x: int) -> int:
        """x mod the modulus."""
        return x % self.value

    @property
    def is_zero(self) -> bool:
        return self.value == 0

    @property
    def bit_count(self) -> int:
        return self.value.bit_length()

    @property
    def const_ratio(self) -> tuple[int, int, int]:
        """floor(2^128 / value) as three 64-bit words, low to high (SEAL
        modulus.cpp set_value); zeros for the zero modulus."""
        if not self.value:
            return (0, 0, 0)
        ratio, mask = (1 << 128) // self.value, (1 << 64) - 1
        return (ratio & mask, (ratio >> 64) & mask, ratio >> 128)

    @property
    def is_prime(self) -> bool:
        return self.value != 0 and numth.is_prime(self.value)

    # comparisons by value against a Modulus or an int (modulus.h:315-381)
    def __eq__(self, other) -> bool:
        if isinstance(other, Modulus):
            return self.value == other.value
        if isinstance(other, int):
            return self.value == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.value)

    def __lt__(self, other):
        if not isinstance(other, (Modulus, int)):
            return NotImplemented
        return self.value < int(other)

    def __repr__(self) -> str:
        return f"Modulus({self.value:#x})"


# SEAL's default coefficient moduli (util/globals.cpp:23-233) as bit-size
# shapes: the largest primes p < 2^b with p ≡ 1 (mod 2n), grouped by bit size
# (ascending groups, descending within a group).
_DEFAULT_BIT_SHAPES: dict[int, dict[int, list[tuple[int, int]]]] = {
    128: {1024: [(27, 1)], 2048: [(54, 1)], 4096: [(36, 2), (37, 1)],
          8192: [(43, 2), (44, 3)], 16384: [(48, 3), (49, 6)],
          32768: [(55, 15), (56, 1)]},
    192: {1024: [(19, 1)], 2048: [(37, 1)], 4096: [(25, 3)], 8192: [(38, 4)],
          16384: [(50, 6)], 32768: [(54, 5), (55, 6)]},
    256: {1024: [(14, 1)], 2048: [(29, 1)], 4096: [(58, 1)],
          8192: [(39, 2), (40, 1)], 16384: [(47, 3), (48, 2)],
          32768: [(52, 1), (53, 8)]},
}

# SEAL's historical single-prime entries that do not follow the rule above
# (chosen by an earlier SEAL release), pinned verbatim.
_DEFAULT_OVERRIDES: dict[tuple[int, int], tuple[int, ...]] = {
    (1024, 128): (0x7E00001,),
    (2048, 128): (0x3FFFFFFF000001,),
    (2048, 192): (0x1FFFFC0001,),
    (2048, 256): (0x1FFC0001,),
    (4096, 256): (0x3FFFFFFFF040001,),
}


@functools.lru_cache(maxsize=None)
def _default_coeff_modulus(poly_modulus_degree: int, sec_level: int) -> tuple[int, ...]:
    override = _DEFAULT_OVERRIDES.get((poly_modulus_degree, sec_level))
    if override is not None:
        return override
    shapes = _DEFAULT_BIT_SHAPES[sec_level].get(poly_modulus_degree)
    if shapes is None:
        raise ValueError("no default parameters for this poly_modulus_degree/security level")
    primes: list[int] = []
    for bit_size, count in shapes:
        primes.extend(numth.get_primes(2 * poly_modulus_degree, bit_size, count))
    return tuple(primes)


class CoeffModulus:
    """Factory for coefficient-modulus prime chains."""

    @staticmethod
    def max_bit_count(poly_modulus_degree: int,
                      sec_level: SecLevelType = SecLevelType.TC128) -> int:
        if sec_level == SecLevelType.NONE:
            return COEFF_MOD_COUNT_MAX * MOD_BIT_COUNT_MAX
        return hestdparms.max_bit_count(poly_modulus_degree, int(sec_level))

    # SEAL's PascalCase names (modulus.h:424-559), as seal_tpu has them
    MaxBitCount = max_bit_count

    @staticmethod
    def bfv_default(poly_modulus_degree: int,
                    sec_level: SecLevelType = SecLevelType.TC128) -> list[Modulus]:
        """SEAL's default BFV/BGV coefficient modulus for a degree and a
        security level (modulus.cpp BFVDefault)."""
        if sec_level == SecLevelType.NONE:
            raise ValueError("sec_level cannot be none")
        return [Modulus(v) for v in _default_coeff_modulus(poly_modulus_degree, int(sec_level))]

    BFVDefault = bfv_default

    @staticmethod
    def create(poly_modulus_degree: int, bit_sizes: list[int],
               plain_modulus: "Modulus | int | None" = None) -> list[Modulus]:
        """Distinct NTT-friendly primes, one per requested bit size, in the
        reference's assignment order (modulus.cpp:143-229): per distinct bit
        size, the largest `count` primes ≡ 1 (mod 2n), or (mod lcm(2n, t))
        with a plain modulus t, handed out to the bit_sizes positions
        smallest-first."""
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
        if plain_modulus is not None:
            t = int(plain_modulus)
            factor *= t // numth.gcd(t, factor)
        count_table: dict[int, int] = {}
        for size in bit_sizes:
            count_table[size] = count_table.get(size, 0) + 1
        prime_table = {size: numth.get_primes(factor, size, count)
                       for size, count in count_table.items()}
        return [Modulus(prime_table[size].pop()) for size in bit_sizes]

    Create = create


class PlainModulus:
    """Factory for batching-capable plaintext moduli (modulus.h:540-559):
    primes ≡ 1 (mod 2n)."""

    @staticmethod
    def batching(poly_modulus_degree: int, bit_size: int) -> Modulus:
        return CoeffModulus.create(poly_modulus_degree, [bit_size])[0]

    Batching = batching

    @staticmethod
    def batching_many(poly_modulus_degree: int, bit_sizes: list[int]) -> list[Modulus]:
        return CoeffModulus.create(poly_modulus_degree, bit_sizes)
