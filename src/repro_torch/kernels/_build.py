"""Build and load the port's CUDA kernels (``csrc/*.cu``), and check what
their wrappers pass and get back.

``nvcc`` compiles each source for Hopper (``sm_90a``) into an object, all
sources at once in parallel processes, and links the objects into one
shared library with a plain C interface, under ``kernels/_build/``
(git-ignored), the first time a kernel is launched.  Each object's name
carries a hash of its source, the shared headers (``csrc/*.cuh``) and the
flags, and the library's a hash of the objects, so an edited source or
header builds anew and an unchanged one is reused.
The library is loaded with ``ctypes``; every pointer and the stream are
passed as ``c_void_p``.  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "SOURCES", "build", "check_tensor", "library", "error_string",
           "raise_on_error"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"
SOURCES = ("bfs_sweep.cu", "flash_attention.cu", "ssd_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _digest(*parts: bytes) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return h.hexdigest()[:16]


def _start(cmd: list[str], out: Path, procs: list) -> None:
    """Start nvcc writing to a temporary beside ``out`` (moved into place by
    ``_wait``), so a cut build never leaves a partial file under its name."""
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp{out.suffix}")
    cmd = [*cmd, "-o", str(tmp)]
    procs.append((cmd, tmp, out, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))


def _wait(procs: list) -> str:
    """Wait for every nvcc process; move each output into place; raise with
    the failed commands' output once all have ended."""
    log, failed = [], []
    for cmd, tmp, out, proc in procs:
        text = proc.communicate()[0]
        log.append(text)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(log)


def build() -> tuple[Path, str]:
    """Compile the sources whose objects are missing (in parallel), link the
    library unless one of the same hash exists; return the library's path
    and nvcc's output (with ptxas's register, spill and shared-memory
    report; empty when everything was reused)."""
    flags = " ".join(NVCC_FLAGS).encode()
    headers = [h.read_bytes() for h in sorted(_CSRC.glob("*.cuh"))]
    objs = []
    procs: list = []
    _BUILD.mkdir(exist_ok=True)
    for name in SOURCES:
        src = _CSRC / name
        obj = _BUILD / f"{src.stem}_{_digest(flags, *headers, src.read_bytes())}.o"
        objs.append(obj)
        if not obj.is_file():
            _start([_nvcc(), *NVCC_FLAGS, "-c", str(src)], obj, procs)
    log = _wait(procs)
    lib = _BUILD / f"librepro_torch_kernels_{_digest(*(o.name.encode() for o in objs))}.so"
    if not lib.is_file():
        procs = []
        _start([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
              *map(str, objs)], lib, procs)
        log += _wait(procs)
    return lib, log


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bfs_sweep_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.bfs_sweep_launch.restype = i
        lib.minplus_patch_launch.argtypes = [p, p, p, p] + [i] * 10 + [p]
        lib.minplus_patch_launch.restype = i
        lib.flash_attention_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_bwd_launch.argtypes = [p] * 11 + [i] * 9 + [f, p]
        lib.flash_attention_bwd_launch.restype = i
        lib.flash_attention_probe_launch.argtypes = [p, p, p, p, p, i, p]
        lib.flash_attention_probe_launch.restype = i
        lib.flash_attention_bwd_probe_launch.argtypes = [p] * 8 + [i, p]
        lib.flash_attention_bwd_probe_launch.restype = i
        lib.ssd_intra_chunk_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.ssd_intra_chunk_launch.restype = i
        lib.ssd_probe_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, p]
        lib.ssd_probe_launch.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def error_string(err: int) -> str:
    """CUDA's text for a ``cudaError_t`` returned by a launcher."""
    return library().repro_cuda_error_string(err).decode()


def raise_on_error(err: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if err:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err} ({error_string(err)})")


def check_tensor(name: str, t, shape: tuple, dtypes, device, contiguous: bool = True) -> None:
    """Raise unless ``t`` is a tensor of ``shape`` and one of ``dtypes`` on
    ``device`` (and contiguous, unless told otherwise): what a kernel takes."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
