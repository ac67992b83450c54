#!/usr/bin/env python3
"""Where the time of ``minplus_patch_kernel`` goes at the replica polish's
shape (b=32 proposals, s=2048 rows, n=8192 columns, mmax=16 endpoints), on
one NVIDIA GPU.

Run from the root of a checkout:  python3 benchmarks/torch_patch_ablation.py

It builds the committed ``src/repro_torch/kernels/csrc/bfs_sweep.cu`` and
variants of it made by replacing one piece of its text (each replacement
must match), one ``nvcc`` per source, all at once, into the git-ignored
``src/repro_torch/kernels/_build/ablation/``; holds the stream
instantiation that ``patch_plan`` picks bit-exact against
``patch_apply_ref``; and times with CUDA events (``chip_smoke.cuda_ms``), in
turns (every entry, then every entry in reverse order):

- the committed plan and other rings of the same kernel (rows per stage,
  stages, strip width; a ring above about 113 KB leaves one block an SM);
- the variants;
- the tile instantiation, and ``out.copy_(dist)`` of the same state: what
  moving those bytes alone takes.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

SOURCE = os.path.join(ROOT, "src/repro_torch/kernels/csrc/bfs_sweep.cu")
OUT = os.path.join(ROOT, "src/repro_torch/kernels/_build/ablation")

ADDMIN = "  a.x = __viaddmin_s32(t, c.x, a.x);\n  a.y = __viaddmin_s32(t, c.y, a.y);\n" \
         "  a.z = __viaddmin_s32(t, c.z, a.z);\n  a.w = __viaddmin_s32(t, c.w, a.w);"
STORE = "        __stcs(reinterpret_cast<int4*>(out + (long long)(st.row + i) * n + x), a);"
ROWS = "#pragma unroll 2\n      for (int i = 0; i < st.nr; ++i) {"
BOUNDS = "__launch_bounds__(kPatchThreads, M <= 16 ? 2 : 1)"

# name: (text replacements, ring (rows, stages, warps) or None for the plan's)
VARIANTS = {
    "an add and a min (no DPX intrinsic)":
        ([(ADDMIN, "  a.x = min(t + c.x, a.x);\n  a.y = min(t + c.y, a.y);\n"
                   "  a.z = min(t + c.z, a.z);\n  a.w = min(t + c.w, a.w);")], None),
    "default stores (no __stcs)":
        ([(STORE, "        *reinterpret_cast<int4*>(out + (long long)(st.row + i) * n + x) = a;")],
         None),
    "rows one at a time (#pragma unroll 1)":
        ([(ROWS, ROWS.replace("unroll 2", "unroll 1"))], None),
    "one block an SM (no register cap), 12 stages x 4 rows":
        ([(BOUNDS, "__launch_bounds__(kPatchThreads, 1)")], (4, 12, 8)),
    "no add-min (a copy through the ring; values wrong)":
        ([(ADDMIN, "  (void)t; (void)c;")], None),
}


def build_all(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Build every source; print ptxas's report and the add and min opcodes
    of the first (the committed kernel)."""
    import chip_smoke as cs
    from repro_torch.kernels import _build

    os.makedirs(OUT, exist_ok=True)
    procs = []
    for k, (name, text) in enumerate(sources.items()):
        cu, so = os.path.join(OUT, f"patch{k}.cu"), os.path.join(OUT, f"patch{k}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", os.path.dirname(SOURCE), "-shared",
             "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        if not libs:
            for line in cs.ptxas_summary(log):
                print(f"{name}: {line}", flush=True)
            for func, ops in sorted(cs.sass_opcodes(so, "minplus_patch").items()):
                print(f"{name}: SASS {func}: VIADDMNMX {ops['VIADDMNMX']}, IMNMX "
                      f"{ops['IMNMX']}, IADD3 {ops['IADD3']}", flush=True)
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.minplus_patch_launch.argtypes = [p, p, p, p] + [i] * 10 + [p]
        lib.bfs_sweep_launch.argtypes = [p, p, p, p] + [i] * 9 + [p]
        lib.bfs_sweep_launch.restype = i
        lib.minplus_patch_launch.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_patch_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import bfs_sweep as bs

    cs.phase_device()
    with open(SOURCE) as f:
        src = f.read()
    sources = {"committed kernel": src}
    for name, (edits, _) in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its text to replace is not in the "
                                   "source once")
            text = text.replace(old, new)
        sources[name] = text
    t0 = time.perf_counter()
    libs = build_all(sources)
    print(f"built {len(libs)} sources in {time.perf_counter() - t0:.1f} s", flush=True)
    committed = libs.pop("committed kernel")
    _build._LIB = committed

    b, s, n, mmax = 32, 2048, 8192, 16
    gen = torch.Generator(device="cuda").manual_seed(0)
    dist = torch.randint(0, 16, (b, s, n), generator=gen, device="cuda", dtype=torch.int32)
    tmp = torch.randint(1, 24, (b, s, mmax), generator=gen, device="cuda", dtype=torch.int32)
    tmp[:, :, mmax - 3:] = int(bs.PATCH_INF)
    crows = torch.randint(0, 16, (b, mmax, n), generator=gen, device="cuda", dtype=torch.int32)
    want = bs.patch_apply_ref(dist, tmp, crows)
    plan = bs.patch_plan(b, s, n, mmax)
    out = torch.empty_like(dist)
    bs._launch_patch(dist, tmp, crows, out, plan)
    torch.cuda.synchronize()
    cs.check(torch.equal(out, want), "committed minplus_patch_kernel != patch_apply_ref")
    del want
    print(f"b={b} s={s} n={n} mmax={mmax}: committed plan {plan} bit-exact", flush=True)

    def ring(rows, stages, warps=8):
        strip = 128 * warps
        return plan._replace(threads=32 * (warps + 1), strip=strip, rows=rows, stages=stages,
                             smem_bytes=bs._patch_smem(mmax, strip, rows, stages))

    entries = {f"committed plan: {plan.stages} stages x {plan.rows} rows, strip {plan.strip}":
               (committed, plan)}
    for rows, stages, warps in ((4, 3, 8), (4, 5, 8), (2, 6, 8), (4, 8, 8), (4, 6, 4)):
        p = ring(rows, stages, warps)
        entries[f"{stages} stages x {rows} rows, strip {p.strip} ({p.smem_bytes} B)"] = \
            (committed, p)
    for name, lib in libs.items():
        entries[name] = (lib, plan if VARIANTS[name][1] is None else ring(*VARIANTS[name][1]))
    entries["tile instantiation"] = (committed, bs.patch_plan(b, s, n, mmax, aligned=False))
    times = {name: [] for name in entries}
    times["out.copy_(dist)"] = []
    for name in list(times) + list(times)[::-1]:
        if name == "out.copy_(dist)":
            times[name].append(cs.cuda_ms(lambda: out.copy_(dist)))
            continue
        lib, p = entries[name]
        _build._LIB = lib
        times[name].append(cs.cuda_ms(lambda: bs._launch_patch(dist, tmp, crows, out, p)))
    _build._LIB = committed
    for name, ms in times.items():
        print(f"{name}: {ms[0]:.4f} ms, {ms[1]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
