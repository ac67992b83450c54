#!/usr/bin/env python3
"""Replay two polish rows of ``benchmarks/bench_search.py`` with the PyTorch
port on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 benchmarks/torch_bench_search.py [--out results/benchmarks/BENCH_torch_search.json]

Rows (the specs of ``bench_search.py``'s full, non-smoke rows):

- ``polish_n8192_k8_pallas``: ``symmetric_sa_search(8192, 8, seed=0,
  n_iter=6, fold=8, start_offsets=<pinned (8192, 8) circulant>)`` priced on
  the card (``SymmetricAPSP`` through ``bfs_sweep_kernel`` and
  ``minplus_patch_kernel``) against the same call on the CPU (the kernels'
  plain PyTorch versions), the port's host baseline.
- ``polish_n8192_k8_delta``: ``large_search(8192, 8, seed=0, budget=8,
  fold=8, replicas=2, polish_iters=8, exchange_every=4, proposal_batch=2)``
  on the card with ``delta=True`` against ``delta=False``.

Each pair walks one trajectory, so ``engine_mpl == mpl`` is asserted, and
``speedup`` is the baseline's host time over the engine's (each ending in a
device synchronise; the kernels are built and loaded before the first
timer).  The card's name and power limit are printed and stored with the
rows.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_bench_search: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import metrics
    from repro_torch.core.known_optimal import KNOWN_CIRCULANT_OFFSETS
    from repro_torch.core.search import large_search, symmetric_sa_search
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.library()
    results = []

    n, k, fold, iters = 8192, 8, 8, 6
    lb = metrics.mpl_lower_bound(n, k)
    kw = dict(seed=0, n_iter=iters, fold=fold, start_offsets=KNOWN_CIRCULANT_OFFSETS[(n, k)])
    symmetric_sa_search(n, k, **{**kw, "n_iter": 1}, device="cuda")  # warm-up
    res_c, card_s = _timed(lambda: symmetric_sa_search(n, k, device="cuda", **kw))
    t0 = time.perf_counter()
    res_h = symmetric_sa_search(n, k, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    assert res_c.mpl == res_h.mpl, "card and CPU trajectories diverged"
    results.append({
        "name": f"polish_n{n}_k{k}_pallas", "n": n, "k": k, "fold": fold, "iters": iters,
        "engine": "cuda", "baseline": "cpu (plain PyTorch versions)",
        "engine_s": card_s, "seed_s": cpu_s, "speedup": cpu_s / card_s,
        "engine_mpl": res_c.mpl, "mpl": res_h.mpl, "mpl_lb": lb,
        "gap_pct": (res_c.mpl / lb - 1) * 100,
        "evals_delta": res_c.evals_delta, "evals_full": res_c.evals_full})

    iters, m = 8, 2
    kw = dict(seed=0, budget=iters, fold=fold, replicas=2, polish_iters=iters,
              exchange_every=max(2, iters // 2), proposal_batch=m, device="cuda")
    large_search(n, k, **{**kw, "polish_iters": 1})  # warm-up
    res_d, delta_s = _timed(lambda: large_search(n, k, delta=True, **kw))
    res_f, full_s = _timed(lambda: large_search(n, k, delta=False, **kw))
    assert res_d.mpl == res_f.mpl, "delta pricing diverged from the full sweep"
    results.append({
        "name": f"polish_n{n}_k{k}_delta", "n": n, "k": k, "fold": fold, "iters": iters,
        "replicas": 2, "proposal_batch": m, "engine": "cuda delta", "baseline": "cuda full",
        "engine_s": delta_s, "seed_s": full_s, "speedup": full_s / delta_s,
        "engine_mpl": res_d.mpl, "mpl": res_f.mpl, "mpl_lb": lb,
        "gap_pct": (res_d.mpl / lb - 1) * 100,
        "evals_delta": res_d.evals_delta, "evals_full": res_d.evals_full,
        "device_dispatches": res_d.device_dispatches})

    out = {"machine": {"device": torch.cuda.get_device_name(0), "nvidia_smi": card,
                       "torch": torch.__version__, "cuda": torch.version.cuda},
           "results": results}
    for row in results:
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
