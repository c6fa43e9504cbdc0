"""Host-side exact number theory (Python big ints, runs once per context).

The port's own copy of seal_tpu/utils/numth.py (the port imports nothing of
seal_tpu). Functional parity with SEAL's util/numth.{h,cpp}; all algorithms here are
standard and re-derived from the math, with two deliberate improvements:

* primality: deterministic Miller-Rabin witness set (exact for all 64-bit
  inputs) instead of the reference's 40 random rounds (numth.cpp:160-275) —
  same verdict on every actual prime/composite, no RNG dependence.
* minimal primitive root: the reference picks a random primitive root and
  scans its odd-power orbit (numth.cpp:386-412); the minimum over that orbit
  is the set of ALL primitive degree-th roots, hence unique and deterministic.
  We compute the same value without randomness.
"""

from __future__ import annotations

# Deterministic Miller-Rabin witnesses: exact for all n < 3.317e24 > 2^64.
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def reverse_bits(value: int, bit_count: int) -> int:
    """Reverse the low `bit_count` bits of `value` (ref: util/uintcore.h)."""
    result = 0
    for _ in range(bit_count):
        result = (result << 1) | (value & 1)
        value >>= 1
    return result


def get_significant_bit_count(value: int) -> int:
    return value.bit_length()


def get_power_of_two(value: int) -> int:
    """log2(value) if value is a power of two, else -1."""
    if value <= 0 or (value & (value - 1)) != 0:
        return -1
    return value.bit_length() - 1


def is_prime(value: int) -> bool:
    """Deterministic 64-bit primality test (parity: util/numth.cpp:160-275)."""
    if value < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13):
        if value == p:
            return True
        if value % p == 0:
            return False
    d = value - 1
    r = 0
    while d & 1 == 0:
        d >>= 1
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, value)
        if x == 1 or x == value - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % value
            if x == value - 1:
                break
        else:
            return False
    return True


def get_primes(factor: int, bit_size: int, count: int) -> list[int]:
    """Largest `count` primes < 2^bit_size that are ≡ 1 (mod factor),
    in descending order (parity: util/numth.cpp:278-311)."""
    if count <= 0:
        raise ValueError("count must be positive")
    if not (2 <= bit_size <= 61):
        raise ValueError("bit_size is invalid")
    result: list[int] = []
    value = ((1 << bit_size) - 1) // factor * factor + 1
    lower_bound = 1 << (bit_size - 1)
    while count > 0 and value > lower_bound:
        if is_prime(value):
            result.append(value)
            count -= 1
        value -= factor
    if count > 0:
        raise RuntimeError("failed to find enough qualifying primes")
    return result


def get_prime(factor: int, bit_size: int) -> int:
    return get_primes(factor, bit_size, 1)[0]


def gcd(x: int, y: int) -> int:
    while y:
        x, y = y, x % y
    return x


def xgcd(x: int, y: int) -> tuple[int, int, int]:
    """Returns (g, a, b) with a*x + b*y = g = gcd(x, y)
    (parity: util/numth.h:78-116, iterative extended Euclid)."""
    prev_a, a = 1, 0
    prev_b, b = 0, 1
    while y != 0:
        q = x // y
        x, y = y, x - q * y
        prev_a, a = a, prev_a - q * a
        prev_b, b = b, prev_b - q * b
    return x, prev_a, prev_b


def are_coprime(x: int, y: int) -> bool:
    return gcd(x, y) == 1


def try_invert_uint_mod(value: int, modulus: int) -> int | None:
    """Modular inverse of value mod modulus, or None if not invertible."""
    value %= modulus
    if value == 0:
        return None
    g, a, _ = xgcd(value, modulus)
    if g != 1:
        return None
    return a % modulus


def invert_uint_mod(value: int, modulus: int) -> int:
    result = try_invert_uint_mod(value, modulus)
    if result is None:
        raise ValueError(f"{value} is not invertible mod {modulus}")
    return result


def naf(value: int) -> list[int]:
    """Non-adjacent form decomposition: value == sum of returned signed
    powers of two (parity: util/numth.h:22-41). Used by rotation fallback."""
    res: list[int] = []
    sign = value < 0
    value = abs(value)
    i = 0
    while value:
        zi = (2 - (value & 3)) if (value & 1) else 0
        value = (value - zi) >> 1
        if zi:
            res.append((-zi if sign else zi) * (1 << i))
        i += 1
    return res


def is_primitive_root(root: int, degree: int, modulus: int) -> bool:
    """True iff root is a primitive degree-th root of unity mod modulus
    (degree a power of two ⇒ suffices that root^(degree/2) == -1)."""
    if root == 0:
        return False
    return pow(root, degree >> 1, modulus) == modulus - 1


def try_primitive_root(degree: int, modulus: int) -> int | None:
    """Any primitive degree-th root of unity mod modulus (deterministic:
    scans small candidates instead of the reference's random draws)."""
    group_size = modulus - 1
    quotient_size = group_size // degree
    if group_size != quotient_size * degree:
        return None
    for candidate in range(2, modulus):
        root = pow(candidate, quotient_size, modulus)
        if is_primitive_root(root, degree, modulus):
            return root
    return None


def try_minimal_primitive_root(degree: int, modulus: int) -> int | None:
    """Smallest primitive degree-th root of unity mod modulus — the unique
    value the reference's randomized search converges to
    (util/numth.cpp:386-412): min over the odd-power orbit of any primitive
    root, which enumerates all primitive roots."""
    root = try_primitive_root(degree, modulus)
    if root is None:
        return None
    generator_sq = (root * root) % modulus
    current = root
    best = root
    for _ in range(0, degree, 2):
        if current < best:
            best = current
        current = (current * generator_sq) % modulus
    return best


def multiply_many(values: list[int]) -> int:
    result = 1
    for v in values:
        result *= v
    return result
