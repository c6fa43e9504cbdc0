"""Build and bind the port's host C++ code: SEAL's blake2xb byte stream.

csrc/blake2xb.cpp is compiled by g++ at its first use into a shared library
in build/seal_tpu_torch/ (beside the CUDA kernels, through cuda.py's build
cache), under a name that carries a hash of its source, its flags and the
host, and loaded with ctypes. It is built with -march=native for the host
it runs on, so the host is part of the name: a build directory copied to
another machine is built again there, not run on a CPU that may lack its
instructions. A failed build raises with the compiler's output; nothing
falls back to the numpy XOF (randomgen.blake2xb_refills_plain), which stays
as the plain version the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import platform
import shutil

from seal_tpu_torch import cuda

SOURCE = cuda.CSRC / "blake2xb.cpp"
REFILL_BYTES = 4096

_lib = None


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native byte stream needs a C++ compiler")
    return found


def _job():
    flags = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
    if platform.machine() in ("x86_64", "AMD64"):
        # one 512-bit register per vector of eight u64 lanes, where the host
        # has them (g++'s default tuning splits such vectors in two)
        flags += ("-mprefer-vector-width=512",)
    return _gxx, SOURCE, flags, (f"{platform.node()} {platform.machine()}",)


def build() -> float:
    """Compile the library unless it is built; returns the seconds it took.
    Raises with the compiler's output if the build fails."""
    return cuda.compile_libraries([_job()])


def library():
    global _lib
    if _lib is None:
        _lib = cuda.load(*_job(), {"sealtorch_blake2xb_refills": [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p]})
    return _lib


def blake2xb_refills(seed_bytes: bytes, counter: int, count: int) -> bytes:
    """Refills counter .. counter + count - 1 of the blake2xb stream of a
    64-byte seed: count * 4096 bytes."""
    if len(seed_bytes) != 64:
        raise ValueError("the seed is 64 bytes")
    if not (0 <= counter and 0 <= count and counter + count <= 1 << 64):
        raise ValueError("refill counters run from 0 to 2^64 - 1")
    out = bytearray(count * REFILL_BYTES)
    if count:
        buf = (ctypes.c_char * len(out)).from_buffer(out)
        rc = library().sealtorch_blake2xb_refills(seed_bytes, counter, count, buf)
        if rc:
            raise RuntimeError(f"sealtorch_blake2xb_refills returned {rc}")
    return bytes(out)
