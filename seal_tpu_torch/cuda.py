"""Build, load and count the port's hand-written CUDA kernels.

Each source in csrc/ is compiled by nvcc for sm_90a into a shared library
with a plain C interface and loaded with ctypes. A library is built at its
first use into build/seal_tpu_torch/ beside the package (a directory that
.gitignore lists), under a name that carries a hash of its source and flags,
so an edited source is never served a stale library. native.py builds the
host byte stream through the same functions, with g++.

`launches` counts calls of each kernel per wrapper. Only the wrappers in
ops/ntt.py and ops/keyswitch.py add to it, once per call that launches. A
key-switch call is one kernel launch. An NTT call is one transform and
counts once, though it launches one kernel for n <= 512 and two (the column
and the chunk pass of csrc/ntt.cu) for larger n. A CUDA graph replay
(jit.py) adds the counts its wrappers made while the graph was captured:
the kernels the graph holds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "seal_tpu_torch"
SOURCES = ("ntt", "keyswitch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

launches = {"ntt_forward": 0, "ntt_inverse": 0, "keyswitch_inner": 0,
            "keyswitch_inner_shoup": 0}

_libs: dict = {}


def reset_launches():
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(source: Path, flags: tuple, salt: tuple = ()) -> Path:
    """Where the library of `source` built with `flags` lives: its name
    hashes the source, the flags and `salt` (any further text the build
    depends on)."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags + salt).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def compile_libraries(jobs) -> float:
    """Compile each (compiler, source, flags, salt) of `jobs` whose library
    is not built yet, one process per source, all started together;
    `compiler` is a function that returns the compiler's path. Returns the
    seconds it took; raises with the compiler's output if any build fails."""
    start = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for compiler, source, flags, salt in jobs:
        lib = library_path(source, flags, salt)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        exe = compiler()
        running.append((source, exe, lib, tmp, subprocess.Popen(
            [exe, *flags, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for source, exe, lib, tmp, proc in running:
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{Path(exe).name} failed on {source.name}:\n"
                          f"{out.decode(errors='replace')}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - start


def load(compiler, source: Path, flags: tuple, salt: tuple, signatures: dict):
    """The library of one job (see compile_libraries), built if need be and
    loaded with ctypes. Every C entry returns an int; `signatures` maps each
    entry to its ctypes argument types."""
    compile_libraries([(compiler, source, flags, salt)])
    lib = ctypes.CDLL(str(library_path(source, flags, salt)))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _job(name: str):
    return _nvcc, CSRC / f"{name}.cu", NVCC_FLAGS, ()


def build(names=SOURCES) -> float:
    """Compile every kernel library of `names` that is not built yet, one
    nvcc per source, all started together (compile_libraries)."""
    return compile_libraries([_job(name) for name in names])


def library(name: str, signatures: dict):
    """The loaded library of csrc/<name>.cu, built on first use; every C
    entry returns a cudaError_t."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = load(*_job(name), signatures)
    return lib


def check(rc: int, what: str):
    """Raise if a C entry reported a CUDA error (a cudaError_t)."""
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def stream_ptr(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
