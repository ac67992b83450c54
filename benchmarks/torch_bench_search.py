#!/usr/bin/env python3
"""Search-engine benchmark on the PyTorch port (the counterpart of
``benchmarks/bench_search.py``): wall time + best-MPL-vs-Cerf-bound gap,
every row of the reference under its name and fields.

    python3 benchmarks/torch_bench_search.py [--smoke] [--device cpu]
        [--only sa_,circulant_,...] [--out path.json]

Every timed search runs through ``repro_torch.api.search(spec, device=)``,
and each row stores its ``SearchSpec`` as the spec's JSON (``spec``), so a
row replays with ``api.search(SearchSpec.from_json(json.dumps(row["spec"])))``.
``--device`` defaults to the CUDA device (the run stops without one);
``--device cpu`` runs the kernels' plain PyTorch versions.  ``--smoke``
takes the reference's smoke sizes; ``--only`` runs the rows whose names
start with one of the given prefixes.

Rows:

- ``sa_n32_k4``, ``sa_n64_k4``: ``sa_search`` (one chain, no early stop;
  the host C fast path) against the seed repo's full-recompute SA loop
  (``_seed_sa_search``, BFS from every vertex per proposal) at equal
  iteration count;
- ``warmstart_n32_k4``: a chain started at the certified table's graph
  against a cold start;
- ``sa_replicas1_n64``, ``sa_replicas4_n64``: replica scaling;
- ``circulant_n*_k*``: the circulant tier (``circulant_search``; its numpy
  pricer below n = 4096);
- ``polish_n*_k*``: ``symmetric_sa_search`` with ``SymmetricAPSP`` on the
  device (``bfs_sweep_kernel`` and ``minplus_patch_kernel`` on the card)
  against ``incremental=False``'s dense host pricing (``_mpl_fast`` from
  n / fold sources a proposal), the same trajectory.  The reference pins
  ``engine="bitset"`` at n >= 8192; the port has no row engines
  (``device=`` replaces them), so the spec's engine is None there;
- ``polish_n8192_k8_pallas``: the same search on the device against the
  CPU (the kernels' plain PyTorch versions, the port's host baseline);
- ``polish_n8192_k8_delta``: the replica polish with delta pricing against
  the full re-sweep, both on the device;
- ``fig4_schedule``: the ``collective-time`` objective's topology and its
  synthesized allreduce schedule (``repro_torch.comm.schedules``) against
  the ring schedule on ring and torus (``core.netsim``).

Each pair that walks one trajectory asserts ``engine_mpl == mpl``.  Times
are host seconds ending in a device synchronise; the kernels and the C fast
path are built before the first timer.  ``machine`` holds the card's
``nvidia-smi`` name and power limit and whether the C fast path was built.
Prints ``bench_search/<row>,us,derived`` CSV rows and one JSON line per
row, and saves ``results/torch_benchmarks/BENCH_search.json``.  Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import platform
import subprocess
import sys
import time

if __package__ in (None, ""):  # executed as a script: bootstrap the paths
    _REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, _REPO)
    sys.path.insert(0, os.path.join(_REPO, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks import torch_common as common  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import SearchSpec  # noqa: E402
from repro_torch.core import _fastpath, metrics  # noqa: E402
from repro_torch.core.graphs import random_hamiltonian_regular, ring  # noqa: E402
from repro_torch.core.known_optimal import KNOWN_CIRCULANT_OFFSETS  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


# the reference's cases, (smoke, full)
SA_CASES = ([(32, 4)], [(32, 4), (64, 4)])  # (n, k)
REPLICA_CASES = ((), (1, 4))  # replicas at (64, 4)
CIRCULANT_CASES = ([(256, 6, 200)], [(256, 4, 400), (512, 6, 400), (1024, 8, 400)])  # n, k, iters
POLISH_CASES = ([(2048, 6, 8, 12), (8192, 8, 16, 6)],  # n, k, fold, iters
                [(2048, 6, 8, 40), (4096, 8, 8, 24), (8192, 8, 8, 12), (16384, 8, 16, 6)])
PALLAS_CASES = ([(8192, 8, 16, 4)], [(8192, 8, 8, 6)])  # n, k, fold, iters
DELTA_CASES = ([(8192, 8, 8, 4, 2)], [(8192, 8, 8, 8, 2)])  # n, k, fold, iters, batch


def row_names(smoke: bool = False) -> list[str]:
    """Every row ``run`` emits at this size, in order."""
    i = 0 if smoke else 1
    return ([f"sa_n{n}_k{k}" for n, k in SA_CASES[i]] + ["warmstart_n32_k4"]
            + [f"sa_replicas{r}_n64" for r in REPLICA_CASES[i]]
            + [f"circulant_n{n}_k{k}" for n, k, _ in CIRCULANT_CASES[i]]
            + [f"polish_n{n}_k{k}" for n, k, *_ in POLISH_CASES[i]]
            + [f"polish_n{n}_k{k}_pallas" for n, k, *_ in PALLAS_CASES[i]]
            + [f"polish_n{n}_k{k}_delta" for n, k, *_ in DELTA_CASES[i]] + ["fig4_schedule"])


def _spec_dict(spec: SearchSpec) -> dict:
    return json.loads(spec.to_json())


# ------------------------------------------------------------------------------
# Faithful seed baseline: full APSP recompute per proposal (the reference
# benchmark's copy, frozen so the speedup stays measurable).
# ------------------------------------------------------------------------------

def _mpl_full(adj: np.ndarray) -> tuple[float, float]:
    n = adj.shape[0]
    a32 = adj.astype(np.float32)
    reach = np.eye(n, dtype=bool)
    frontier = reach.astype(np.float32)
    total = 0.0
    d = 0
    while True:
        nxt = (frontier @ a32) > 0
        newf = nxt & ~reach
        if not newf.any():
            break
        d += 1
        total += d * newf.sum()
        reach |= newf
        frontier = newf.astype(np.float32)
    if not reach.all():
        return float("inf"), float("inf")
    return total / (n * (n - 1)), float(d)


def _seed_sa_search(n, k, seed=0, n_iter=4000, t_start=0.1, t_end=1e-4):
    """The seed repo's Algorithm 1 loop, verbatim semantics."""
    rng = np.random.default_rng(seed)
    g0 = random_hamiltonian_regular(n, k, seed=seed)
    adj = g0.adjacency()
    ring_mask = ring(n).adjacency()
    gamma = math.exp(math.log(t_end / t_start) / n_iter)
    cur_mpl, cur_d = _mpl_full(adj)
    best_mpl, best_d = cur_mpl, cur_d
    t = t_start
    for _ in range(n_iter):
        iu, ju = np.where(np.triu(adj & ~ring_mask))
        t *= gamma
        if len(iu) < 2:
            continue
        e1, e2 = rng.choice(len(iu), size=2, replace=False)
        a, b = int(iu[e1]), int(ju[e1])
        c, d = int(iu[e2]), int(ju[e2])
        if len({a, b, c, d}) != 4:
            continue
        p1, p2 = ((a, c), (b, d)) if rng.integers(2) else ((a, d), (b, c))
        if adj[p1] or adj[p2]:
            continue
        prop = adj.copy()
        prop[a, b] = prop[b, a] = False
        prop[c, d] = prop[d, c] = False
        prop[p1] = prop[p1[::-1]] = True
        prop[p2] = prop[p2[::-1]] = True
        new_mpl, new_d = _mpl_full(prop)
        dm = new_mpl - cur_mpl
        if dm < 0 or rng.random() < math.exp(-dm / max(t, 1e-12)):
            adj, cur_mpl, cur_d = prop, new_mpl, new_d
            if (cur_mpl, cur_d) < (best_mpl, best_d):
                best_mpl, best_d = cur_mpl, cur_d
    return best_mpl, best_d


def _card() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def run(smoke: bool = False, device=None, only: tuple[str, ...] | None = None) -> common.Rows:
    """Run the selected rows on ``device``; returns the ``Rows`` (CSV rows,
    ``.results`` and ``.meta``)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    size = 0 if smoke else 1
    rows = common.Rows("bench_search", artifact="search")
    results = rows.results

    def wanted(name: str) -> bool:
        return only is None or any(name.startswith(p) for p in only)

    def timed(fn):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # build the C fast path and the kernels (first use compiles them: keep
    # that out of the timed regions) and prime numpy/BLAS
    _fastpath.library()
    if on_card:
        from repro_torch.kernels import _build

        _build.library()
    api.search(SearchSpec.make(12, 3, strategy="sa", budget=20, replicas=1, target_mpl=None),
               device=dev)

    # --- SA engine vs seed full-recompute, equal iteration count -----------
    # replicas=1 + target_mpl=None pin the single-chain, no-early-stop
    # trajectory the seed baseline walks, so the row isolates the evaluator
    n_iter = 1000 if smoke else 4000
    for (n, k) in SA_CASES[size]:
        if not wanted(f"sa_n{n}_k{k}"):
            continue
        lb = metrics.mpl_lower_bound(n, k)
        spec = SearchSpec.make(n, k, seed=0, strategy="sa", budget=n_iter,
                               replicas=1, target_mpl=None)
        res, engine_s = timed(lambda: api.search(spec, device=dev))
        t0 = time.perf_counter()
        seed_mpl, _ = _seed_sa_search(n, k, seed=0, n_iter=n_iter)
        seed_s = time.perf_counter() - t0
        speedup = seed_s / engine_s if engine_s > 0 else float("inf")
        rows.add(f"sa_n{n}_k{k}", engine_s,
                 f"{n_iter} iters engine={engine_s:.3f}s seed={seed_s:.3f}s "
                 f"speedup={speedup:.1f}x mpl={res.mpl:.4f} (seed {seed_mpl:.4f}) "
                 f"lb={lb:.4f} delta={res.evals_delta} full={res.evals_full}")
        results.append({
            "name": f"sa_n{n}_k{k}", "n": n, "k": k, "iters": n_iter,
            "engine_s": engine_s, "seed_s": seed_s, "speedup": speedup,
            "engine_mpl": res.mpl, "seed_mpl": seed_mpl, "mpl_lb": lb,
            "gap_pct": round((res.mpl / lb - 1) * 100, 2),
            "evals_delta": res.evals_delta, "evals_full": res.evals_full,
            "spec": _spec_dict(spec),
        })

    # --- certified-table warm start vs cold start ---------------------------
    # at a pinned (n, k) the warm chain starts AT the certified optimum, so
    # warm_mpl <= cold_mpl must hold at any budget
    if wanted("warmstart_n32_k4"):
        ws_iter = 300 if smoke else 1500
        cold_spec = SearchSpec.make(32, 4, seed=1, strategy="sa", budget=ws_iter,
                                    replicas=1, target_mpl=None)
        warm_spec = cold_spec.with_overrides(params={**cold_spec.kwargs, "warm_start": True})
        res_cold, cold_s = timed(lambda: api.search(cold_spec, device=dev))
        res_warm, warm_s = timed(lambda: api.search(warm_spec, device=dev))
        lb = metrics.mpl_lower_bound(32, 4)
        rows.add("warmstart_n32_k4", warm_s,
                 f"{ws_iter} iters warm={res_warm.mpl:.4f} ({warm_s:.3f}s) "
                 f"cold={res_cold.mpl:.4f} ({cold_s:.3f}s) lb={lb:.4f}")
        results.append({
            "name": "warmstart_n32_k4", "n": 32, "k": 4, "iters": ws_iter,
            "warm_s": warm_s, "cold_s": cold_s,
            "warm_mpl": res_warm.mpl, "cold_mpl": res_cold.mpl, "mpl_lb": lb,
            "gap_pct": round((res_warm.mpl / lb - 1) * 100, 2),
            "spec": _spec_dict(warm_spec),
        })

    # --- replica scaling: quality at fixed schedule -------------------------
    for r in REPLICA_CASES[size]:
        if not wanted(f"sa_replicas{r}_n64"):
            continue
        spec = SearchSpec.make(64, 4, seed=0, strategy="sa", budget=4000,
                               replicas=r, target_mpl=None)
        res, dt = timed(lambda: api.search(spec, device=dev))
        lb = metrics.mpl_lower_bound(64, 4)
        rows.add(f"sa_replicas{r}_n64", dt,
                 f"mpl={res.mpl:.4f} gap={(res.mpl / lb - 1) * 100:.1f}%")
        results.append({
            "name": f"sa_replicas{r}_n64", "n": 64, "k": 4, "replicas": r,
            "wall_s": dt, "mpl": res.mpl, "mpl_lb": lb,
            "gap_pct": round((res.mpl / lb - 1) * 100, 2),
            "spec": _spec_dict(spec),
        })

    # --- large-N circulant tier ---------------------------------------------
    for (n, k, iters) in CIRCULANT_CASES[size]:
        if not wanted(f"circulant_n{n}_k{k}"):
            continue
        lb = metrics.mpl_lower_bound(n, k)
        spec = SearchSpec.make(n, k, seed=0, strategy="circulant", budget=iters)
        res, dt = timed(lambda: api.search(spec, device=dev))
        rows.add(f"circulant_n{n}_k{k}", dt,
                 f"mpl={res.mpl:.4f} lb={lb:.4f} gap={(res.mpl / lb - 1) * 100:.1f}% "
                 f"D={res.diameter:.0f} offs={list(res.offsets or ())}")
        results.append({
            "name": f"circulant_n{n}_k{k}", "n": n, "k": k, "iters": iters,
            "wall_s": dt, "mpl": res.mpl, "mpl_lb": lb,
            "gap_pct": round((res.mpl / lb - 1) * 100, 2),
            "diameter": res.diameter, "offsets": list(res.offsets or ()),
            "spec": _spec_dict(spec),
        })

    # --- large-N polish tier: SymmetricAPSP on the device vs the dense host
    # pricing (equal iteration count, same seed and warm start: the
    # trajectories are the same, so the MPL columns must agree and speedup
    # isolates the evaluator)
    for (n, k, fold, iters) in POLISH_CASES[size]:
        if not wanted(f"polish_n{n}_k{k}"):
            continue
        lb = metrics.mpl_lower_bound(n, k)
        offs = KNOWN_CIRCULANT_OFFSETS[(n, k)]
        spec = SearchSpec.make(n, k, seed=0, strategy="symmetric-sa",
                               budget=iters, fold=fold, start_offsets=list(offs),
                               incremental=True)
        res, engine_s = timed(lambda: api.search(spec, device=dev))
        seed_spec = spec.with_overrides(params={**spec.kwargs, "incremental": False})
        res_seed, seed_s = timed(lambda: api.search(seed_spec, device=dev))
        assert res.mpl == res_seed.mpl, "incremental pricing diverged from the dense pricing"
        speedup = seed_s / engine_s if engine_s > 0 else float("inf")
        rows.add(f"polish_n{n}_k{k}", engine_s,
                 f"{iters} orbit iters fold={fold} engine={dev.type} "
                 f"{engine_s:.3f}s seed={seed_s:.3f}s speedup={speedup:.1f}x "
                 f"mpl={res.mpl:.4f} (seed {res_seed.mpl:.4f}) lb={lb:.4f} "
                 f"delta={res.evals_delta} full={res.evals_full}")
        results.append({
            "name": f"polish_n{n}_k{k}", "n": n, "k": k, "fold": fold,
            "iters": iters, "engine": dev.type,
            "engine_s": engine_s, "seed_s": seed_s, "speedup": speedup,
            "engine_mpl": res.mpl, "mpl": res_seed.mpl, "seed_mpl": res_seed.mpl,
            "mpl_lb": lb,
            "gap_pct": round((res.mpl / lb - 1) * 100, 2),
            "evals_delta": res.evals_delta, "evals_full": res.evals_full,
            "spec": _spec_dict(spec),
        })

    # --- the device sweep vs the CPU (the kernels' plain versions) ----------
    for (n, k, fold, iters) in PALLAS_CASES[size]:
        if not wanted(f"polish_n{n}_k{k}_pallas"):
            continue
        lb = metrics.mpl_lower_bound(n, k)
        offs = KNOWN_CIRCULANT_OFFSETS[(n, k)]
        spec_p = SearchSpec.make(n, k, seed=0, strategy="symmetric-sa",
                                 budget=iters, fold=fold, start_offsets=list(offs))
        api.search(spec_p.with_overrides(budget=1), device=dev)  # warm-up
        res_p, dev_s = timed(lambda: api.search(spec_p, device=dev))
        t0 = time.perf_counter()
        res_b = api.search(spec_p, device="cpu")
        cpu_s = time.perf_counter() - t0
        assert res_p.mpl == res_b.mpl, "device and CPU trajectories diverged"
        speedup = cpu_s / dev_s if dev_s > 0 else float("inf")
        rows.add(f"polish_n{n}_k{k}_pallas", dev_s,
                 f"{iters} orbit iters fold={fold} {dev.type}={dev_s:.3f}s "
                 f"cpu={cpu_s:.3f}s speedup={speedup:.2f}x mpl={res_p.mpl:.4f} lb={lb:.4f}")
        results.append({
            "name": f"polish_n{n}_k{k}_pallas", "n": n, "k": k, "fold": fold,
            "iters": iters, "engine": dev.type,
            "baseline": "cpu (the kernels' plain PyTorch versions)",
            "engine_s": dev_s, "seed_s": cpu_s, "speedup": speedup,
            "engine_mpl": res_p.mpl, "mpl": res_b.mpl, "mpl_lb": lb,
            "gap_pct": round((res_p.mpl / lb - 1) * 100, 2),
            "evals_delta": res_p.evals_delta, "evals_full": res_p.evals_full,
            "spec": _spec_dict(spec_p),
        })

    # --- delta-priced replica polish vs the full-sweep dispatch -------------
    # both walk the same per-seed trajectory, so engine_mpl == mpl is
    # asserted and speedup isolates the pricing algorithm
    for (n, k, fold, iters, m) in DELTA_CASES[size]:
        if not wanted(f"polish_n{n}_k{k}_delta"):
            continue
        lb = metrics.mpl_lower_bound(n, k)
        spec_d = SearchSpec.make(n, k, seed=0, strategy="large", budget=iters,
                                 fold=fold, replicas=2, polish_iters=iters,
                                 exchange_every=max(2, iters // 2),
                                 proposal_batch=m, delta=True)
        spec_f = spec_d.with_overrides(params={**spec_d.kwargs, "delta": False})
        api.search(spec_d.with_overrides(params={**spec_d.kwargs, "polish_iters": 1}),
                   device=dev)  # warm-up
        res_d, delta_s = timed(lambda: api.search(spec_d, device=dev))
        res_f, full_s = timed(lambda: api.search(spec_f, device=dev))
        assert res_d.mpl == res_f.mpl, "delta pricing diverged from the full sweep"
        speedup = full_s / delta_s if delta_s > 0 else float("inf")
        rows.add(f"polish_n{n}_k{k}_delta", delta_s,
                 f"{iters} orbit iters fold={fold} replicas=2 batch={m} "
                 f"delta={delta_s:.3f}s full={full_s:.3f}s ({dev.type}) "
                 f"speedup={speedup:.2f}x mpl={res_d.mpl:.4f} lb={lb:.4f} "
                 f"delta_evals={res_d.evals_delta} full_evals={res_d.evals_full} "
                 f"dispatches={res_d.device_dispatches}")
        results.append({
            "name": f"polish_n{n}_k{k}_delta", "n": n, "k": k, "fold": fold,
            "iters": iters, "replicas": 2, "proposal_batch": m,
            "baseline": "full-sweep", "engine": dev.type,
            "engine_s": delta_s, "seed_s": full_s, "speedup": speedup,
            "engine_mpl": res_d.mpl, "mpl": res_f.mpl, "mpl_lb": lb,
            "gap_pct": round((res_d.mpl / lb - 1) * 100, 2),
            "evals_delta": res_d.evals_delta, "evals_full": res_d.evals_full,
            "device_dispatches": res_d.device_dispatches,
            "spec": _spec_dict(spec_d),
        })

    # --- co-design tier: objective="collective-time" ------------------------
    # the searched topology + its synthesized allreduce schedule against the
    # ring schedule on the mainstream fig-4 baselines at the same message size
    if wanted("fig4_schedule"):
        from repro_torch.comm import schedules
        from repro_torch.core import netsim

        op, unit = "allreduce", 1 << 18
        spec = SearchSpec.make(16, 4, objective="collective-time", seed=0,
                               budget=150 if smoke else 600, op=op, unit_bytes=unit)
        res, dt = timed(lambda: api.search(spec, device=dev))
        synth = schedules.synthesize(res.graph, op, unit)
        baselines = {name: netsim.collective_bench(
            netsim.TAISHAN(api.build_topology(s, device=dev)), op, float(unit))
            for name, s in (("ring", "ring:16"), ("torus", "torus:4x4"))}
        ratio_ring = baselines["ring"] / synth.time
        ratio_torus = baselines["torus"] / synth.time
        rows.add("fig4_schedule", dt,
                 f"{op}@{unit >> 10}KB synth={synth.algorithm} "
                 f"{synth.time * 1e3:.2f}ms ring={baselines['ring'] * 1e3:.2f}ms "
                 f"torus={baselines['torus'] * 1e3:.2f}ms "
                 f"ratio_vs_ring={ratio_ring:.2f} ratio_vs_torus={ratio_torus:.2f}")
        results.append({
            "name": "fig4_schedule", "n": 16, "k": 4, "op": op,
            "unit_bytes": unit, "wall_s": dt,
            "algorithm": synth.algorithm, "synth_s": synth.time,
            "ring_s": baselines["ring"], "torus_s": baselines["torus"],
            "ratio_vs_ring": round(ratio_ring, 4),
            "ratio_vs_torus": round(ratio_torus, 4),
            "mpl": res.mpl, "spec": _spec_dict(spec),
        })

    rows.meta = {
        "machine": {
            "platform": platform.platform(),
            "python": platform.python_version(),
            "numpy": np.__version__,
            "torch": torch.__version__,
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "nvidia_smi": _card() if on_card else None,
            "c_kernel": _fastpath.build().is_file(),
        },
        "smoke": smoke,
    }
    return rows


def main(argv=None) -> common.Rows:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="the reference's smoke sizes")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; the run stops without one) or cpu")
    ap.add_argument("--only", default=None,
                    help="comma-separated row-name prefixes (e.g. sa_,circulant_)")
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    only = tuple(p for p in args.only.split(",") if p) if args.only else None
    rows = run(smoke=args.smoke, device=args.device, only=only)
    if rows.meta["machine"]["nvidia_smi"]:
        print(rows.meta["machine"]["nvidia_smi"], flush=True)
    rows.emit()
    for row in rows.results:
        print(json.dumps(row), flush=True)
    rows.save()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**rows.meta, "results": rows.results}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
