#!/usr/bin/env python3
"""Where the time of ``bfs_sweep_kernel`` goes at the replica polish's full
re-sweep (b=32 (8192, 8) graphs, all 2048 representative rows, sw_pad=64),
on one NVIDIA GPU.

Run from the root of a checkout:  python3 benchmarks/torch_sweep_ablation.py

It builds the committed ``src/repro_torch/kernels/csrc/bfs_sweep.cu`` and
variants of it made by replacing one piece of its text (each replacement
must match), one ``nvcc`` per source, all at once, into the git-ignored
``src/repro_torch/kernels/_build/ablation/``.  Each variant is timed with
CUDA events (``chip_smoke.cuda_ms``) at the full shape, in turns (every
variant, then every variant in reverse order); the committed kernel is held
bit-exact against ``sweep_rows_ref`` first.  A ``fill_`` of a tensor of the
output's size is timed beside them: what writing those bytes alone takes.
The variants compute wrong distances where they change the output; they
measure, they are not kernels of the port.  Imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

SOURCE = os.path.join(ROOT, "src/repro_torch/kernels/csrc/bfs_sweep.cu")
OUT = os.path.join(ROOT, "src/repro_torch/kernels/_build/ablation")

# the final pass of the shared instantiation, one vertex slot at a time
FINAL_PASS = """#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t codes = 0u;
#pragma unroll
      for (int p = 0; p < P; ++p) codes |= spread_nibbles(L[i][p] >> (8 * q)) << p;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj, out += nn) {
        const int32_t c = (int32_t)((codes >> (4 * jj)) & 15u);
        const bool reached = (V[i] >> (8 * q + jj)) & 1u;
        if (!reached || c) *out = reached ? c : sentinel;
      }
    }"""
STORE = "        if (!reached || c) *out = reached ? c : sentinel;"
START = "  if constexpr (GRAPH == kGraphShared) {\n    if (threadIdx.x == 0) Fa[n] = Fb[n] = 0u;"

VARIANTS = {
    "no final-pass stores (levels, table loads, level-0 writes)":
        [(STORE, "        (void)c; (void)reached;")],
    "final pass storing a constant (no decoding)":
        [(STORE, "        *out = sentinel;")],
    "final pass with streaming stores (__stcs)":
        [(STORE, "        if (!reached || c) __stcs(out, reached ? c : sentinel);")],
    "final pass as 16-byte stores, same bytes (values wrong)":
        [(FINAL_PASS, """    const int base = v & ~3;
    uint32_t codes = 0u;
#pragma unroll
    for (int p = 0; p < P; ++p) codes |= spread_nibbles(L[i][p]) << p;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int j = 4 * m + (threadIdx.x & 3);
      const int4 val = make_int4(codes >> m, V[i] >> m, codes >> (m + 1), sentinel);
      *reinterpret_cast<int4*>(rows + j * nn + base) = val;
    }""")],
    "final pass storing even rows only (half the bytes)":
        [(STORE, "        if ((!reached || c) && !(jj & 1)) *out = reached ? c : sentinel;")],
    "odd blocks start 60 us late (blocks out of phase)":
        [(START, "  if (blockIdx.x & 1) for (int i = 0; i < 60; ++i) __nanosleep(1000);\n" + START)],
}


def build_all(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build

    os.makedirs(OUT, exist_ok=True)
    procs = []
    for k, (name, text) in enumerate(sources.items()):
        cu, so = os.path.join(OUT, f"variant{k}.cu"), os.path.join(OUT, f"variant{k}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", os.path.dirname(SOURCE), "-shared",
             "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bfs_sweep_launch.argtypes = [p, p, p, p] + [i] * 9 + [p]
        lib.bfs_sweep_launch.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_sweep_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import bfs_sweep as bs

    cs.phase_device()
    with open(SOURCE) as f:
        src = f.read()
    sources = {"committed kernel": src}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its text to replace is not in the source once")
            text = text.replace(old, new)
        sources[name] = text
    t0 = time.perf_counter()
    libs = build_all(sources)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)

    n, k, s, b = 8192, 8, 2048, 32
    full = cs.polish_tables(n, k, b)[0]
    nb, vm, F0, _, _ = bs.pack_batch(full, np.arange(s))
    args = tuple(bs.as_words(a, "cuda") for a in (nb, vm, F0))
    want = bs.sweep_rows_ref(*args, n)
    _build._LIB = libs["committed kernel"]
    stale = torch.empty_like(want).fill_(-1)  # the block the result reuses
    del stale
    got = bs.sweep(*args, n)
    torch.cuda.synchronize()
    cs.check(torch.equal(got, want), "committed bfs_sweep_kernel != sweep_rows_ref")
    del got
    print(f"full shape b={b} n={n} kmax={k} sw_pad={F0.shape[2]}: committed kernel bit-exact",
          flush=True)
    out = torch.empty_like(want)
    print(f"fill_ of the output's {out.numel() * 4 / 1e9:.2f} GB: "
          f"{cs.cuda_ms(lambda: out.fill_(7)):.4f} ms", flush=True)
    del out
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        _build._LIB = libs[name]
        times[name].append(cs.cuda_ms(lambda: bs.sweep(*args, n)))
    for name, ms in times.items():
        print(f"{name}: {ms[0]:.4f} ms, {ms[1]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
