"""Runtime configuration of the port.

The port of seal_tpu/config.py (SEAL's compile-time options as runtime
flags). Only the flags that choose a route the port has are here; every
other flag and function of seal_tpu's config is retired, each for the reason
that `RETIRED` gives.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class GlobalConfig:
    # SEAL_THROW_ON_TRANSPARENT_CIPHERTEXT (on in SEAL's default build):
    # relinearize, relinearize_rescale and apply_galois refuse a result
    # whose c1 and above are zero. The check reads the device (one sync
    # per op, one per batch); off, the ops never wait for the card.
    throw_on_transparent_ciphertext: bool = True
    # Shoup-quotient key-switch inner product (ops/keyswitch.py, kernel K3):
    # floor(k·2^64/q) is computed once per loaded key and cached on the key
    # object; the contraction then sums lazy Shoup products and ends with a
    # chain of conditional subtractions instead of a 128-bit sum and one
    # Barrett-128. The same representative in [0, q), so the same bits; used
    # only where the lazy sum fits 64 bits (2·d·max q < 2^64). Off by
    # default, as in seal_tpu.
    keyswitch_shoup: bool = False


config = GlobalConfig()

_TPU_ROUTE = ("chooses a TPU route: the port's wrappers launch K1/K2/K3 on "
              "CUDA tensors and the plain version on CPU tensors")

# seal_tpu/config.py's flags and functions that the port does not have
RETIRED = {
    "use_pallas_ntt": _TPU_ROUTE,
    "pallas_ntt_min_n": _TPU_ROUTE,
    "pallas_ntt_max_n": _TPU_ROUTE,
    "use_pallas_keyswitch": _TPU_ROUTE,
    "pallas_keyswitch_min_n": _TPU_ROUTE,
    "pallas_ntt_enabled": _TPU_ROUTE,
    "pallas_keyswitch_enabled": _TPU_ROUTE,
    "noise_sampler": "no code of seal_tpu reads it",
    "galois_permute": ("chooses the Clos-routed MXU permutation; on the card a "
                       "gather is the route"),
    "galois_matmul_min_n": "as galois_permute",
    "galois_matmul_enabled": "as galois_permute",
    "use_native_keygen": ("chooses seal_tpu's host polynomial math "
                          "(native/poly.py); the port does that math on the card"),
    "enable_compile_cache": ("JAX's compilation cache; the port's counterpart is the "
                             "kernel build cache (build/seal_tpu_torch/, cuda.py, "
                             "native.py), always on"),
}
