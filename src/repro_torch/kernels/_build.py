"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles the sources for Hopper (``sm_90a``) into a shared library
with a plain C interface, under ``kernels/_build/`` (git-ignored), the first
time a kernel is launched.  The library's name carries a hash of the sources
and flags, so an edited source builds anew and an unchanged one is reused.
It is loaded with ``ctypes``; every pointer and the stream are passed as
``c_void_p``.  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "library", "error_string"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"
SOURCES = ("bfs_sweep.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> tuple[Path, str]:
    """Compile the sources unless a library of the same hash exists; return
    the library's path and nvcc's output (with ptxas's register, spill and
    shared-memory report; empty when the library was reused)."""
    srcs = [_CSRC / name for name in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.read_bytes())
    lib = _BUILD / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib, ""
    _BUILD.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    return lib, log


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bfs_sweep_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.bfs_sweep_launch.restype = i
        lib.minplus_patch_launch.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.minplus_patch_launch.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def error_string(err: int) -> str:
    """CUDA's text for a ``cudaError_t`` returned by a launcher."""
    return library().repro_cuda_error_string(err).decode()
