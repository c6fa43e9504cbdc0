"""Runtime configuration of the port.

The port of seal_tpu/config.py (SEAL's compile-time options as runtime
flags). Only the flags that choose a route the port has are here; the
others pick TPU routes.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class GlobalConfig:
    # Shoup-quotient key-switch inner product (ops/keyswitch.py, kernel K3):
    # floor(k·2^64/q) is computed once per loaded key and cached on the key
    # object; the contraction then sums lazy Shoup products and ends with a
    # chain of conditional subtractions instead of a 128-bit sum and one
    # Barrett-128. The same representative in [0, q), so the same bits; used
    # only where the lazy sum fits 64 bits (2·d·max q < 2^64). Off by
    # default, as in seal_tpu.
    keyswitch_shoup: bool = False


config = GlobalConfig()
