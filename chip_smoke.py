#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the device: ``nvidia-smi`` name and power limit, PyTorch's device name;
2. build the CUDA kernels with nvcc (timed);
3. ``bfs_sweep_kernel`` against its plain PyTorch version, bit for bit: the
   pinned (8192, 8) circulant and three more (8192, <=8) graphs, one of them
   disconnected, from its 2048 representative sources; then a delta-shaped
   batch of 32 proposals with few affected rows each;
4. ``minplus_patch_kernel`` against its plain version at the main path's
   shape (b=32, s=2048, n=8192, mmax=8);
5. the main path, ``large_search(8192, 8, replicas=8, proposal_batch=4,
   polish_iters=64)`` on the card, with both kernels' launches counted and
   the result rechecked; then a short delta=False run, which must follow the
   same trajectory as delta=True over the same iterations;
6. the same search at (2048, 6) on the card and on the CPU (the kernels'
   plain versions): every field must be equal.

It prints one ``{"kernels": [...]}`` JSON line (per kernel: launches on the
main path, the largest difference from the plain version, kernel and plain
times from CUDA events, and the least time the card could take), then the
``{"ok": true, "device": {...}}`` line last.  It imports nothing of JAX or
of the JAX package ``repro``.  Without CUDA, or outside a checkout, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, and the int32
# ALU rate (64 int32 lanes per SM x 132 SMs x 1.98 GHz boost clock)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SWEEP_SOURCE = "src/repro_torch/kernels/csrc/bfs_sweep.cu"
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` in ms (CUDA events), after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, nops: float) -> tuple[float, str, str]:
    """Least time the card could take (ms), what bounds it, and both terms."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    terms = f"bytes {t_bytes:.3f} ms, operations {t_ops:.3f} ms"
    if t_bytes >= t_ops:
        return t_bytes, "bytes", terms
    return t_ops, "operations", terms


def circ_nbr(n: int, offsets, kmax: int) -> np.ndarray:
    from repro_torch.core import metrics
    from repro_torch.core.graphs import circulant

    return metrics._nbr_table(circulant(n, offsets).adjacency(), kmax)


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"[1] device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path, out = _build.build()
    _build.library()
    log(f"[2] built {os.path.relpath(path, HERE)} in {time.perf_counter() - t0:.2f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"    {line.strip()}")


def phase_sweep(n: int = 8192, s: int = 2048) -> dict:
    import torch

    from repro_torch.core.known_optimal import KNOWN_CIRCULANT_OFFSETS
    from repro_torch.core.search import _circulant_profile
    from repro_torch.kernels import bfs_sweep as bs

    dev = torch.device(DEV)
    kmax = 8
    offsets = [KNOWN_CIRCULANT_OFFSETS[(n, 8)], KNOWN_CIRCULANT_OFFSETS[(n, 6)],
               KNOWN_CIRCULANT_OFFSETS[(n, 4)], (2, 4, 6, 8)]  # last: 2 components
    nbrs = np.stack([circ_nbr(n, o, kmax) for o in offsets])
    nb, vm, F0, sw_pad, _ = bs.pack_batch(nbrs, np.arange(s))
    nb, vm, F0 = (bs.as_words(a, dev) for a in (nb, vm, F0))
    got = bs.sweep(nb, vm, F0, n)
    want = bs.sweep_rows_ref(nb, vm, F0, n)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "bfs_sweep_kernel != sweep_rows_ref (full batch)")
    err = int((got - want).abs().max())
    # independent of both: every row of a circulant sums to (n - 1) * MPL
    mpl_c, _ = _circulant_profile(n, offsets[0])
    check(int(got[0, :s].sum(dtype=torch.int64)) == s * round(mpl_c * (n - 1)),
          "pinned circulant rows disagree with the host profile")
    check(bool((got[3, :s] == n).any()) and not bool((got[0, :s] == n).any()),
          "sentinel rows wrong")
    ms = cuda_ms(lambda: bs.sweep(nb, vm, F0, n))
    plain_ms = cuda_ms(lambda: bs.sweep_rows_ref(nb, vm, F0, n), reps=3)
    b = nbrs.shape[0]
    levels = [int(got[g][got[g] < n].max()) + 1 for g in range(b)]
    nbytes = (nb.numel() + vm.numel() + F0.numel() + got.numel()) * 4
    nops = sum(lv * n * kmax * sw_pad * 2 for lv in levels)  # AND + OR per gather
    bms, by, terms = bound(nbytes, nops)
    log(f"[3] sweep b={b} n={n} sw_pad={sw_pad}: bit-exact; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({terms}); levels {levels}")

    # delta-shaped: 32 post-removal tables, a few affected rows each, some none
    rng = np.random.default_rng(0)
    nbrs32 = nbrs[np.arange(32) % 3]
    srcs = [np.sort(rng.choice(s, size=int(rng.integers(0, 48)), replace=False))
            for _ in range(32)]
    srcs[5] = np.empty(0, dtype=np.int64)
    nb2, vm2, F02, ids, sw2, _ = bs.pack_delta_batch(nbrs32, srcs, s)
    nb2, vm2, F02 = (bs.as_words(a, dev) for a in (nb2, vm2, F02))
    got2 = bs.sweep(nb2, vm2, F02, n)
    want2 = bs.sweep_rows_ref(nb2, vm2, F02, n)
    torch.cuda.synchronize()
    check(torch.equal(got2, want2), "bfs_sweep_kernel != sweep_rows_ref (delta batch)")
    err = max(err, int((got2 - want2).abs().max()))
    ms2 = cuda_ms(lambda: bs.sweep(nb2, vm2, F02, n))
    log(f"    delta batch b=32 sw_pad={sw2}: bit-exact; kernel {ms2:.3f} ms")
    return {"name": "bfs_sweep_kernel", "route": "cuda", "source": SWEEP_SOURCE,
            "replaces": "src/repro/kernels/bfs_sweep.py:133", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def phase_patch(b: int = 32, s: int = 2048, n: int = 8192, mmax: int = 8) -> dict:
    import torch

    from repro_torch.kernels import bfs_sweep as bs

    gen = torch.Generator(device=DEV).manual_seed(0)
    dist = torch.randint(0, 16, (b, s, n), generator=gen, device=DEV,
                         dtype=torch.int32)
    tmp = torch.randint(1, 24, (b, s, mmax), generator=gen, device=DEV,
                        dtype=torch.int32)
    tmp[:, :, mmax - 3:] = int(bs.PATCH_INF)  # masked endpoint slots
    crows = torch.randint(0, 16, (b, mmax, n), generator=gen, device=DEV,
                          dtype=torch.int32)
    got = bs.patch_apply(dist, tmp, crows)
    want = bs.patch_apply_ref(dist, tmp, crows)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "minplus_patch_kernel != patch_apply_ref")
    check(not torch.equal(got, dist), "patch changed nothing: inputs too weak")
    err = int((got - want).abs().max())
    ms = cuda_ms(lambda: bs.patch_apply(dist, tmp, crows))
    plain_ms = cuda_ms(lambda: bs.patch_apply_ref(dist, tmp, crows), reps=3)
    nbytes = (2 * dist.numel() + tmp.numel() + crows.numel()) * 4
    bms, by, terms = bound(nbytes, 2 * b * s * n * mmax)  # add + min per endpoint
    log(f"[4] patch b={b} s={s} n={n} mmax={mmax}: bit-exact; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({terms})")
    return {"name": "minplus_patch_kernel", "route": "cuda", "source": SWEEP_SOURCE,
            "replaces": "src/repro/kernels/bfs_sweep.py:361", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def _fields(res) -> tuple:
    return (res.graph.edges, res.mpl, res.diameter, res.accepted, res.history,
            res.evals_delta, res.evals_full, res.device_dispatches, res.replicas,
            res.offsets)


def phase_main(n: int = 8192, k: int = 8, fold: int = 4, replicas: int = 8,
               proposal_batch: int = 4, polish_iters: int = 64) -> dict:
    import torch

    from repro_torch.core.engines import cuda_sweep
    from repro_torch.core.known_optimal import KNOWN_CIRCULANT_OFFSETS
    from repro_torch.core.search import _circulant_profile, large_search
    from repro_torch.kernels import bfs_sweep as bs

    kw = dict(seed=0, fold=fold, replicas=replicas, proposal_batch=proposal_batch)
    # wall time inside the pricing dispatches (each ends in a device->host copy)
    spent = {"dispatch_s": 0.0, "dispatches": 0}
    orig = cuda_sweep.sharded_delta_state

    def timed(*a, **k2):
        t = time.perf_counter()
        out = orig(*a, **k2)
        spent["dispatch_s"] += time.perf_counter() - t
        spent["dispatches"] += 1
        return out

    cuda_sweep.sharded_delta_state = timed
    try:
        bs.sweep.launches = bs.patch_apply.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = large_search(n, k, polish_iters=polish_iters, delta=True,
                           device=DEV, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"bfs_sweep_kernel": bs.sweep.launches,
                    "minplus_patch_kernel": bs.patch_apply.launches}
    finally:
        cuda_sweep.sharded_delta_state = orig
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[5] large_search({n}, {k}, replicas={replicas}, proposal_batch="
        f"{proposal_batch}, polish_iters={polish_iters}, delta=True) on {DEV}: "
        f"wall {wall:.2f} s, {spent['dispatches']} dispatches took "
        f"{spent['dispatch_s']:.2f} s, peak device memory {peak:.2f} GiB")
    log(f"    mpl={float(res.mpl)!r} diameter={res.diameter} mpl_lb={res.mpl_lb!r} "
        f"accepted={res.accepted} evals_delta={res.evals_delta} "
        f"evals_full={res.evals_full} device_dispatches={res.device_dispatches} "
        f"launches={launches}")
    check(launches["bfs_sweep_kernel"] > 0 and launches["minplus_patch_kernel"] > 0,
          f"main path did not launch both kernels: {launches}")

    # recheck the returned graph from scratch with the sweep over all s rows
    s = n // fold
    g = res.graph
    from repro_torch.core import metrics

    rows = bs.bfs_rows(metrics._nbr_table(g.adjacency()), np.arange(s), n,
                       device=DEV)
    total = rows.sum(dtype=np.int64)
    check(int(rows.max()) < n, "returned graph is disconnected")
    check(total / (s * (n - 1)) == res.mpl, "recomputed MPL differs from the reported")
    check(float(rows.max()) == res.diameter, "recomputed diameter differs")
    check(g.is_regular() and g.degree() == k, "result is not k-regular")
    es = set(g.edges)
    check(all((min((u + s) % n, (v + s) % n), max((u + s) % n, (v + s) % n)) in es
              for u, v in es), "result is not invariant under rotation by n/fold")
    warm, _ = _circulant_profile(n, KNOWN_CIRCULANT_OFFSETS[(n, k)])
    check(res.mpl_lb <= res.mpl <= warm, "mpl outside [mpl_lb, warm start]")
    log(f"    recheck: mpl and diameter reproduced from {s} fresh BFS rows; "
        f"{k}-regular, rotation-invariant; warm start mpl={warm!r}")

    # delta=False (sharded_rows_totals) follows the delta=True trajectory;
    # the two pricings are timed in turns (full, delta, delta, full)
    walls = {False: [], True: []}
    runs = {}
    for delta in (False, True, True, False):
        t0 = time.perf_counter()
        r = large_search(n, k, polish_iters=8, delta=delta, device=DEV, **kw)
        walls[delta].append(time.perf_counter() - t0)
        runs[delta] = (r.graph.edges, r.mpl, r.diameter, r.history, r.accepted)
    check(runs[False] == runs[True], "delta=False and delta=True trajectories differ")
    log(f"    8 iterations: delta=False {walls[False]} s, delta=True {walls[True]} s, "
        f"same trajectory (mpl={float(runs[True][1])!r}, accepted={runs[True][4]})")
    for delta in (False, True):
        profile_run(lambda: large_search(n, k, polish_iters=8, delta=delta,
                                         device=DEV, **kw), f"delta={delta}")
    return launches


def profile_run(fn, label: str) -> None:
    """Device time of one run by kernel (torch.profiler), against its wall
    time: how much of the run keeps the card busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, memsets), as torch's own
    # table totals them, so no time is counted twice
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"    profiled 8 iterations, {label}: device busy {busy:.3f} s of "
        f"{wall:.2f} s wall ({100 * busy / wall:.1f}%); top device time:")
    for us, count, key in rows[:6]:
        log(f"      {us / 1e3:10.2f} ms  x{count:<5d} {key[:72]}")


def phase_card_vs_cpu() -> None:
    from repro_torch.core.search import large_search

    kw = dict(seed=0, fold=4, replicas=4, proposal_batch=2, polish_iters=8)
    t0 = time.perf_counter()
    a = large_search(2048, 6, device=DEV, **kw)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = large_search(2048, 6, device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    check(_fields(a) == _fields(b), "card and CPU paths differ at (2048, 6)")
    log(f"[6] large_search(2048, 6) card == CPU in every field (mpl={float(a.mpl)!r}, "
        f"accepted={a.accepted}); cuda {t_gpu:.2f} s, cpu {t_cpu:.2f} s")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    kernels = [phase_sweep(), phase_patch()]
    launches = phase_main()
    phase_card_vs_cpu()
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
