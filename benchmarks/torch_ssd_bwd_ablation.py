#!/usr/bin/env python3
"""Where the time of the bf16 SSD backward (``ssd_bwd_col_bf16_kernel``,
``ssd_bwd_row_bf16_kernel`` and ``ssd_intra_chunk_bwd_finish_kernel``) goes
at mamba2-2.7b's and zamba2-2.7b's training shapes (b*h 640, s 1024, p 64,
n 128 and 64, chunk 256), on one NVIDIA GPU.

Run from the root of a checkout:  python3 benchmarks/torch_ssd_bwd_ablation.py

It builds the committed ``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu`` and
variants of it made by replacing pieces of its text (each replacement must
match as often as it says), one ``nvcc`` per source, all at once, into the
git-ignored ``src/repro_torch/kernels/_build/ablation/``, and calls each
library's ``ssd_intra_chunk_bwd_bf16_launch`` as the wrapper does.  The
committed kernel is held to ``ssd_intra_chunk_bwd_plain`` first.  Each
variant's call is timed with CUDA events (``chip_smoke.cuda_ms``) in turns
(every variant, then every variant in reverse order), and its passes apart
with torch.profiler.  The variants compute wrong gradients where they
change the arithmetic; they measure, they are not kernels of the port.
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

SOURCE = os.path.join(ROOT, "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu")
OUT = os.path.join(ROOT, "src/repro_torch/kernels/_build/ablation")
SHAPES = (("mamba2-2.7b", 640, 1024, 64, 128, 256), ("zamba2-2.7b", 640, 1024, 64, 64, 256))

SHUFFLES = """#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              cg[0] += __shfl_xor_sync(0xffffffffu, cg[0], off);
              cg[1] += __shfl_xor_sync(0xffffffffu, cg[1], off);
            }"""
COL_EXP = "ex2((e ? cl.y : cl.x) + bj[h])"
SPLIT_STORE = "*reinterpret_cast<uint2*>(d + k * term_bytes) = bits;"

# name: [(old, new, occurrences)]
VARIANTS = {
    "loader 40 registers, computing warpgroup 216": [
        ("setmaxnreg.dec.sync.aligned.u32 56;", "setmaxnreg.dec.sync.aligned.u32 40;", 2),
        ("setmaxnreg.inc.sync.aligned.u32 200;", "setmaxnreg.inc.sync.aligned.u32 216;", 2)],
    "one block an SM, 255 registers each (no setmaxnreg)": [
        ("__launch_bounds__(2 * kWg, 2)", "__launch_bounds__(2 * kWg, 1)", 2),
        ('asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\\n");', "", 2),
        ('asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\\n");', "", 2)],
    "no G row-sum shuffles (column pass; sums wrong)": [(SHUFFLES, "", 1)],
    "no exp off the column pass's diagonal tiles (L = 1; values wrong)": [(COL_EXP, "1.f", 1)],
    "gy and gst loaded but not stored (values wrong)": [(SPLIT_STORE, "(void)bits;", 1)],
}


def build_all(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build

    os.makedirs(OUT, exist_ok=True)
    procs = []
    for k, (name, text) in enumerate(sources.items()):
        cu = os.path.join(OUT, f"ssd_bwd_variant{k}.cu")
        so = os.path.join(OUT, f"ssd_bwd_variant{k}.so")
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
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and "bytes spill stores" in line]
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_intra_chunk_bwd_bf16_launch.argtypes = [p] * 13 + [i] * 5 + [p]
        lib.ssd_intra_chunk_bwd_bf16_launch.restype = i
        libs[name] = lib
        print(f"  built {name!r}; ptxas spill lines with stores: "
              f"{sum(' 0 bytes spill stores' not in s for s in spills)} of {len(spills)}",
              flush=True)
    return libs


def call(lib, args, chunk):
    """The wrapper's bf16 path with library ``lib``: outputs and scratch
    allocated, one launch."""
    import torch

    x, dt, A, B, C, gy, gst = args
    bh, s, p = x.shape
    n = B.shape[-1]
    dx, dB, dC = torch.empty_like(x), torch.empty_like(B), torch.empty_like(C)
    ddt = torch.empty((bh, s), dtype=torch.float32, device=x.device)
    dA = torch.empty((bh, 1), dtype=torch.float32, device=x.device)
    scratch = torch.empty((3 + chunk // 64, bh, s), dtype=torch.float64, device=x.device)
    err = lib.ssd_intra_chunk_bwd_bf16_launch(
        *(t.data_ptr() for t in (x, dt, A, B, C, gy, gst, dx, ddt, dA, dB, dC, scratch)),
        bh, s, p, n, chunk, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd_intra_chunk_bwd_bf16_launch failed: cudaError {err}")
    return dx, ddt, dA, dB, dC


def passes(lib, args, chunk) -> str:
    """Each launch's device ms a call, from torch.profiler over five calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call(lib, args, chunk)
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        for name in ("ssd_bwd_col_bf16_kernel", "ssd_bwd_row_bf16_kernel",
                     "ssd_intra_chunk_bwd_finish_kernel"):
            if e.device_type == DeviceType.CUDA and name in e.key:
                out.append(f"{name} {e.self_device_time_total / 1e3 / 5:.4f}")
    return ", ".join(sorted(out))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_ssd_bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan as ssd

    cs.phase_device()
    with open(SOURCE) as f:
        src = f.read()
    sources = {"committed kernel": src}
    for name, edits in VARIANTS.items():
        text = src
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"variant {name!r}: {old[:40]!r} is in the source "
                                   f"{text.count(old)} times, not {count}")
            text = text.replace(old, new)
        sources[name] = text
    t0 = time.perf_counter()
    libs = build_all(sources)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(4)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    for label, bh, s, p, n, chunk in SHAPES:
        b16 = torch.bfloat16
        args = (rnd(bh, s, p).to(b16), torch.nn.functional.softplus(rnd(bh, s)),
                -torch.exp(0.5 * rnd(bh, 1)), (0.5 * rnd(bh, s, n)).to(b16),
                (0.5 * rnd(bh, s, n)).to(b16), rnd(bh, s, p), rnd(bh, s // chunk, p, n))
        got = call(libs["committed kernel"], args, chunk)
        want = ssd.ssd_intra_chunk_bwd_plain(*args, chunk)
        torch.cuda.synchronize()
        err = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
               for g, w in zip(got, want)]
        cs.check(max(err[0], err[3], err[4]) <= 1e-2 and max(err[1], err[2]) <= 1e-5,
                 f"the committed kernel != plain at {label}: {err}")
        del got, want
        print(f"{label} (bh={bh} s={s} p={p} n={n} chunk={chunk}): committed kernel within "
              f"tolerance of the plain version", flush=True)
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            times[name].append(cs.cuda_ms(lambda: call(libs[name], args, chunk)))
        for name, ms in times.items():
            print(f"  {name}: {ms[0]:.4f} ms, {ms[1]:.4f} ms; {passes(libs[name], args, chunk)}",
                  flush=True)
        del args
    return 0


if __name__ == "__main__":
    sys.exit(main())
