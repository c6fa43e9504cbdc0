"""Build, load and count the port's hand-written CUDA kernels.

Each source in csrc/ is compiled by nvcc for sm_90a into a shared library
with a plain C interface and loaded with ctypes. A library is built at its
first use into build/seal_tpu_torch/ beside the package (a directory that
.gitignore lists), under a name that carries a hash of its source and flags,
so an edited source is never served a stale library.

`launches` counts calls of each kernel per wrapper. Only the wrappers in
ops/ntt.py and ops/keyswitch.py add to it, once per call that launches. A
key-switch call is one kernel launch. An NTT call is one transform and
counts once, though it launches one kernel for n <= 512 and two (the column
and the chunk pass of csrc/ntt.cu) for larger n.
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


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> float:
    """Compile every library of `names` that is not built yet, one nvcc per
    source, all started together. Returns the seconds it took; raises with
    the compiler's output if any build fails."""
    start = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src, lib = _paths(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{name}.cu:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("nvcc failed\n" + "\n".join(errors))
    return time.perf_counter() - start


def library(name: str, signatures: dict):
    """The loaded library of csrc/<name>.cu, built on first use. Every C
    entry returns an int (a cudaError_t); `signatures` maps each entry to
    its ctypes argument types."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_paths(name)[1]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(rc: int, what: str):
    """Raise if a C entry reported a CUDA error (a cudaError_t)."""
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def stream_ptr(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
