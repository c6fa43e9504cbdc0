"""HomomorphicEncryption.org security standard tables.

Largest allowed total coeff_modulus bit counts per (poly_modulus_degree,
security level), for ternary secrets. Values are the public standard's
tables, as consumed by the reference (util/hestdparms.h:19-144). The port's
own copy of seal_tpu/utils/hestdparms.py.
"""

from __future__ import annotations

# {poly_modulus_degree: max total log2(q)} — ternary secret, classical
HE_STD_PARMS_128_TC = {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438, 32768: 881}
HE_STD_PARMS_192_TC = {1024: 19, 2048: 37, 4096: 75, 8192: 152, 16384: 305, 32768: 611}
HE_STD_PARMS_256_TC = {1024: 14, 2048: 29, 4096: 58, 8192: 118, 16384: 237, 32768: 476}

# Ternary secret, quantum
HE_STD_PARMS_128_TQ = {1024: 25, 2048: 51, 4096: 101, 8192: 202, 16384: 411, 32768: 827}
HE_STD_PARMS_192_TQ = {1024: 17, 2048: 35, 4096: 70, 8192: 141, 16384: 284, 32768: 571}
HE_STD_PARMS_256_TQ = {1024: 13, 2048: 27, 4096: 54, 8192: 109, 16384: 220, 32768: 443}

# Standard deviation of the error distribution (util/hestdparms.h:145)
HE_STD_PARMS_ERROR_STD_DEV = 3.2


def max_bit_count(poly_modulus_degree: int, sec_level: int) -> int:
    """Max total log2(q) for the given degree at classical security level
    `sec_level` ∈ {128, 192, 256}; 0 if out of table (parity:
    modulus.cpp CoeffModulus::MaxBitCount)."""
    table = {
        128: HE_STD_PARMS_128_TC,
        192: HE_STD_PARMS_192_TC,
        256: HE_STD_PARMS_256_TC,
    }.get(sec_level)
    if table is None:
        return 0
    return table.get(poly_modulus_degree, 0)
