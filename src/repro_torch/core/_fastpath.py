"""The SA tier's host C fast path (the counterpart of
``repro.core._fastpath``).

``csrc/fastpath.c`` is a byte-equal copy of the reference's C source.  The
host's C compiler (``$CC``, default ``cc``) builds it with the reference's
flags (``-O3 -shared -fPIC``) into ``kernels/_build/`` (git-ignored) the
first time an entry point is called; the library's name carries a hash of
the source and the flags, and the build writes a temporary file that is
then moved into place, so processes that build at once never load a
partial library.  A failed build raises with the compiler's output: there
is no switch to the numpy path and no fallback.

Four entry points are bound with ``ctypes``, with the reference's argument
types: ``apsp_rows`` (queue BFS rows), ``parent_counts`` (BFS-DAG parent
counts), ``eval_swap`` (one 2-out/2-in swap priced by delta evaluation)
and ``sa_chunk`` (a chunk of the annealing loop of ``sa_search``).  Each
takes numpy arrays; the caller owns every buffer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["FLAGS", "SOURCE", "build", "library", "apsp_rows", "parent_counts", "eval_swap",
           "sa_chunk"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "fastpath.c"
FLAGS = ("-O3", "-shared", "-fPIC")
_BUILD = Path(__file__).resolve().parent.parent / "kernels" / "_build"

_LIB: ctypes.CDLL | None = None


def build() -> Path:
    """Compile ``fastpath.c`` unless a library of the same source and flags
    exists; return its path.  Raises ``RuntimeError`` with the compiler's
    output when the build fails."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD / f"librepro_torch_fastpath_{tag}.so"
    if lib.is_file():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [os.environ.get("CC", "cc"), *FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as exc:
        raise RuntimeError(f"C compiler failed to start: {' '.join(cmd)}\n{exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"C compiler failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded fast-path library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        c_int, c_i32, c_i64, c_f64 = ctypes.c_int, ctypes.c_int32, ctypes.c_int64, ctypes.c_double
        i32p = ctypes.POINTER(ctypes.c_int32)
        i16p = ctypes.POINTER(ctypes.c_int16)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.apsp_rows.argtypes = [c_int, c_int, c_int, i32p, i32p, i32p]
        lib.apsp_rows.restype = None
        lib.parent_counts.argtypes = [c_int, c_int, c_int, i32p, i32p, i16p]
        lib.parent_counts.restype = None
        lib.eval_swap.argtypes = [c_int, c_int, i32p, i32p, i16p, i32p, i32p, c_int, c_f64,
                                  c_int, c_i64, i32p, i64p, i32p, i32p]
        lib.eval_swap.restype = c_i32
        lib.sa_chunk.argtypes = [c_int, c_int, i32p, i32p, i16p, u8p, u8p, i32p, c_i32,
                                 c_i32, c_i32, i32p, i32p, i32p, f64p, f64p, c_f64, c_f64,
                                 i64p, i32p, i64p, i32p, c_i64, i32p, i64p, i32p, i32p,
                                 i32p, i64p]
        lib.sa_chunk.restype = c_i32
        _LIB = lib
    return _LIB


_DTYPES = {ctypes.c_int16: np.int16, ctypes.c_int32: np.int32, ctypes.c_int64: np.int64,
           ctypes.c_double: np.float64, ctypes.c_uint8: np.uint8}


def _ptr(a: np.ndarray, ctype):
    """``a``'s data as a C pointer, once its dtype and layout are the C side's."""
    if a.dtype != _DTYPES[ctype] or not a.flags.c_contiguous:
        raise ValueError(f"the C fast path takes C-contiguous {np.dtype(_DTYPES[ctype])} "
                         f"arrays, got {a.dtype} (contiguous: {a.flags.c_contiguous})")
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check_square(n: int, scratch: np.ndarray, *mats: np.ndarray) -> None:
    if scratch.size < 8 * n or any(m.shape != (n, n) for m in mats):
        raise ValueError(f"the C fast path takes (n, n) = ({n}, {n}) matrices and 8n scratch, "
                         f"got {[m.shape for m in mats]} and {scratch.size}")


def apsp_rows(nbr: np.ndarray, out: np.ndarray, scratch: np.ndarray) -> None:
    """Hop distances from sources 0..out.shape[0]-1 into ``out`` (int32,
    sentinel n) over the padded neighbour table ``nbr`` (pad -1)."""
    n, kmax = nbr.shape
    if out.ndim != 2 or out.shape[1] != n or out.shape[0] > n or scratch.size < n:
        raise ValueError(f"apsp_rows: out {out.shape}, scratch {scratch.size} for n = {n}")
    library().apsp_rows(n, kmax, out.shape[0], _ptr(nbr, ctypes.c_int32),
                        _ptr(out, ctypes.c_int32), _ptr(scratch, ctypes.c_int32))


def parent_counts(nbr: np.ndarray, dist: np.ndarray, npar: np.ndarray) -> None:
    """npar[s, x] = the number of neighbours w of x with dist[s, w] + 1 ==
    dist[s, x], written in place (int16)."""
    n, kmax = nbr.shape
    if dist.ndim != 2 or dist.shape[1] != n or npar.shape != dist.shape:
        raise ValueError(f"parent_counts: dist {dist.shape}, npar {npar.shape} for n = {n}")
    library().parent_counts(n, kmax, dist.shape[0], _ptr(nbr, ctypes.c_int32),
                            _ptr(dist, ctypes.c_int32), _ptr(npar, ctypes.c_int16))


def eval_swap(nbr, dist, npar, rem, add, force_full: bool, full_frac: float,
              want_max: bool, base_total: int, newdist, scratch) -> tuple[int, int, int]:
    """Price the swap removing (rem[0], rem[1]), (rem[2], rem[3]) and adding
    ``add`` likewise into ``newdist``; returns (naff, total, max): naff is -1
    when the full rebuild ran, max -1 when deferred (``want_max`` false and
    the graph provably connected).  ``scratch`` is 8n int32, zeroed once at
    allocation."""
    n, kmax = nbr.shape
    _check_square(n, scratch, dist, npar, newdist)
    if rem.size != 4 or add.size != 4:
        raise ValueError("eval_swap takes two removed and two added edges")
    total = ctypes.c_int64()
    mx = ctypes.c_int32()
    naff = library().eval_swap(
        n, kmax, _ptr(nbr, ctypes.c_int32), _ptr(dist, ctypes.c_int32),
        _ptr(npar, ctypes.c_int16), _ptr(rem, ctypes.c_int32), _ptr(add, ctypes.c_int32),
        int(force_full), float(full_frac), int(want_max), int(base_total),
        _ptr(newdist, ctypes.c_int32), ctypes.byref(total), ctypes.byref(mx),
        _ptr(scratch, ctypes.c_int32))
    return int(naff), int(total.value), int(mx.value)


def sa_chunk(*, nbr, dist, npar, adj, best_adj, chords, chunk_iters: int, iter_base: int,
             de1, de2, dorient, du, t: float, gamma: float, full_frac: float,
             cur_total: int, cur_diam: int, best_total: int, best_diam: int,
             target_total: int, hist_iters, hist_totals, hist_io, newdist, scratch,
             stats) -> dict:
    """Run a chunk of the annealing loop in C over the pre-drawn randomness
    (``de1``, ``de2``, ``dorient``, ``du``); the arrays are updated in place
    and the scalars returned: ``done`` (iterations run), ``t``,
    ``cur_total``, ``cur_diam``, ``best_total``, ``best_diam``."""
    n, kmax = nbr.shape
    _check_square(n, scratch, dist, adj, best_adj, newdist)
    if npar is not None:
        _check_square(n, scratch, npar)
    if chords.shape[1:] != (2,) or min(len(de1), len(de2), len(dorient), len(du)) < chunk_iters \
            or hist_iters.size < hist_io[0] or hist_totals.size < hist_io[0] or stats.size < 4:
        raise ValueError("sa_chunk: a buffer is smaller than the chunk, the history or the stats")
    t_c = ctypes.c_double(t)
    cur_t = ctypes.c_int64(cur_total)
    cur_d = ctypes.c_int32(cur_diam)
    best_t = ctypes.c_int64(best_total)
    best_d = ctypes.c_int32(best_diam)
    done = library().sa_chunk(
        n, kmax, _ptr(nbr, ctypes.c_int32), _ptr(dist, ctypes.c_int32),
        None if npar is None else _ptr(npar, ctypes.c_int16),
        _ptr(adj.view(np.uint8), ctypes.c_uint8), _ptr(best_adj.view(np.uint8), ctypes.c_uint8),
        _ptr(chords, ctypes.c_int32), chords.shape[0], int(chunk_iters), int(iter_base),
        _ptr(de1, ctypes.c_int32), _ptr(de2, ctypes.c_int32), _ptr(dorient, ctypes.c_int32),
        _ptr(du, ctypes.c_double), ctypes.byref(t_c), float(gamma), float(full_frac),
        ctypes.byref(cur_t), ctypes.byref(cur_d), ctypes.byref(best_t), ctypes.byref(best_d),
        int(target_total), _ptr(hist_iters, ctypes.c_int32), _ptr(hist_totals, ctypes.c_int64),
        _ptr(hist_io, ctypes.c_int32), _ptr(newdist, ctypes.c_int32),
        _ptr(scratch, ctypes.c_int32), _ptr(stats, ctypes.c_int64))
    return {"done": int(done), "t": t_c.value, "cur_total": int(cur_t.value),
            "cur_diam": int(cur_d.value), "best_total": int(best_t.value),
            "best_diam": int(best_d.value)}
