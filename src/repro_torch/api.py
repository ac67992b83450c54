"""``repro_torch.api`` — the one facade over the paper's whole pipeline (the
counterpart of ``repro.api``).

The paper's loop is *pick a topology family → minimise MPL → benchmark the
cluster*.  This module is that loop as one API: declarative specs
(:class:`TopologySpec` / :class:`SearchSpec` from ``core.specs``), the
registries that validate them (``core.topologies`` families, ``core.specs``
strategies and objectives), and :func:`run_experiment`, which prices a whole
suite of topologies and feeds them to the ``netsim``/``collectives``
workloads the paper benchmarks.

    from repro_torch import api

    # build: one entry point for every family (spec object or legacy string)
    g = api.build_topology("torus:4x8")
    g = api.build_topology(api.TopologySpec.make("circulant", n=64, offsets=[1, 9]))

    # search: one dispatch for every tier, auto-resolved by N
    res = api.search(api.SearchSpec(n=32, k=4, seed=0), device="cpu")

    # benchmark: a suite of specs through the simulated cluster workloads
    exp = api.run_experiment(api.paper_suite("256"),
                             workloads=["stats", ("alltoall", {"unit_bytes": 1 << 16})])
    print(exp.table())

Everything here is re-exported from the core layers — the facade adds
spec-keyed caching for the searched families (:func:`build_topology`'s
``cache_dir=``, the reference's ``CACHE_VERSION`` and key, so a reference
cache file holds the same graph) and the workload registry behind
:func:`run_experiment`.  Results equal the reference's
(``tests/test_torch_specs_api.py``).

Where the port differs: ``device`` is a keyword of :func:`build_topology`,
:func:`search` and :func:`run_experiment`, never part of a spec.  ``None``
is the CUDA device and raises without one; ``"cpu"`` runs the kernels'
plain versions.  It reaches the searched families' builds and the workloads
that price on the device (``needs_device``: today ``stats``); the netsim
workloads run on the host.  ``parallel=True`` forks a process pool, and a
process forked after CUDA is initialised cannot use the card, so on a CUDA
device it raises ``ValueError`` before anything is built.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Callable, Iterable, Mapping

import torch

from .core import metrics, netsim
from .core.graphs import Graph, from_edges
from .core.search import CIRCULANT_ENGINES, SearchResult
from .core.specs import (SearchSpec, TopologySpec, check_engine,
                         objective_names, register_objective,
                         register_strategy, search, search_strategies,
                         strategy_engine_domain)
from .core.topologies import (build_topology as _build_topology, paper_suite,
                              parse_topology, register_topology,
                              topology_families)

__all__ = [
    "TopologySpec",
    "SearchSpec",
    "SearchResult",
    "Graph",
    "build_topology",
    "parse_topology",
    "search",
    "run_experiment",
    "ExperimentResult",
    "paper_suite",
    "topology_families",
    "search_strategies",
    "engine_names",
    "workload_names",
    "objective_names",
    "register_topology",
    "register_strategy",
    "register_workload",
    "register_objective",
    "main",
]


def engine_names() -> dict[str, tuple[str, ...]]:
    """The engine names by kind.  The port has no row engines (the orbit and
    SA tiers price on ``device``); the circulant tier takes its pricers."""
    return {"rows": (), "circulant": tuple(CIRCULANT_ENGINES)}


# --------------------------------------------------------------------------------
# build_topology with spec-keyed caching for the searched families
# --------------------------------------------------------------------------------

# Bump whenever the search trajectories behind the searched families change
# (new PRNG consumption, different tier defaults, ...), so a pre-existing
# results/benchcache cannot silently serve graphs from older search code —
# the spec-cache successor of the legacy benchmarks.common CACHE_VERSION.
CACHE_VERSION = 3


def _cache_key(spec: TopologySpec) -> str:
    digest = hashlib.sha256(spec.to_json().encode()).hexdigest()[:16]
    return f"spec_v{CACHE_VERSION}_{spec.family}_{digest}"


def build_topology(
    spec: TopologySpec | str | Graph,
    *,
    cache_dir: str | None = None,
    device=None,
    **kw,
) -> Graph:
    """Build a topology from a spec object / legacy string / ready Graph.

    With ``cache_dir``, graphs of *searched* families (``optimal`` /
    ``suboptimal`` — the ones whose construction runs a seeded search) are
    cached as edge-list JSON keyed by the spec's canonical JSON hash, so
    re-runs are instant while staying fully reproducible from scratch (the
    cache file also embeds the spec for provenance).  Constructive families
    build directly — they are cheaper than the disk round trip.  ``device``
    is where a searched family prices; the graph, and so the cache file,
    does not depend on it.
    """
    if isinstance(spec, Graph):
        return spec
    from .core import topologies as topo_mod

    # one normalisation point shared with the core builder, so kw overrides
    # land in the spec and caching/provenance always see them
    spec = topo_mod.normalize_topology(spec, **kw)
    if cache_dir is None or not topo_mod.get_family(spec.family).searched:
        return _build_topology(spec, device)
    os.makedirs(cache_dir, exist_ok=True)
    fn = os.path.join(cache_dir, _cache_key(spec) + ".json")
    if os.path.exists(fn):
        with open(fn) as f:
            d = json.load(f)
        return from_edges(d["n"], [tuple(e) for e in d["edges"]], d["name"])
    g = _build_topology(spec, device)
    with open(fn, "w") as f:
        json.dump({"n": g.n, "edges": [list(e) for e in g.edges],
                   "name": g.name, "spec": json.loads(spec.to_json())}, f)
    return g


# --------------------------------------------------------------------------------
# Workload registry — the netsim/collectives benchmarks as named, parameterised
# cells run_experiment dispatches to.
# --------------------------------------------------------------------------------

_WORKLOADS: dict[str, Callable] = {}

#: registered workload names, in registration order
WORKLOADS: tuple[str, ...] = ()


def register_workload(name: str, fn: Callable, *,
                      replace: bool = False) -> Callable:
    """Register a workload: ``fn(graph, cluster, **params) -> value``.

    ``cluster`` is the routed :class:`repro_torch.core.netsim.Cluster` (None
    for graph-only workloads declared with ``needs_cluster=False``
    attribute).  A workload with ``needs_device=True`` also receives
    ``device=`` (the experiment's device); the others run on the host.
    Re-registering an existing name raises unless ``replace=True`` — a
    silent overwrite would let one extension shadow another's workload.
    """
    global WORKLOADS
    if name in _WORKLOADS and not replace:
        raise ValueError(
            f"workload {name!r} is already registered; pass replace=True "
            "to override it")
    _WORKLOADS[name] = fn
    if name not in WORKLOADS:
        WORKLOADS = WORKLOADS + (name,)
    return fn


def workload_names() -> tuple[str, ...]:
    return WORKLOADS


def _wl_stats(g, cl, **kw):
    return metrics.stats(g, **kw)


_wl_stats.needs_cluster = False
_wl_stats.needs_device = True
register_workload("stats", _wl_stats)
register_workload("pingpong_fit",
                  lambda g, cl, **kw: dict(zip(("T0", "alpha", "rho"),
                                               netsim.pingpong_fit(cl, **kw))))
register_workload("pingpong_mean",
                  lambda g, cl, **kw: netsim.pingpong_mean_latency(cl, **kw))
register_workload("collective",
                  lambda g, cl, op="alltoall", unit_bytes=1 << 20, **kw:
                  netsim.collective_bench(cl, op, float(unit_bytes), **kw))
register_workload("collective_synth",
                  lambda g, cl, op="allreduce", unit_bytes=1 << 20, **kw:
                  netsim.collective_bench(cl, op, float(unit_bytes),
                                          schedule="synth", **kw))
register_workload("alltoall",
                  lambda g, cl, unit_bytes=1 << 20, **kw:
                  netsim.collective_bench(cl, "alltoall", float(unit_bytes), **kw))
register_workload("beff",
                  lambda g, cl, **kw: netsim.effective_bandwidth(cl, **kw))
register_workload("ffte",
                  lambda g, cl, array_len=1 << 24, **kw:
                  netsim.ffte_1d(cl, int(array_len), **kw))
register_workload("graph500",
                  lambda g, cl, **kw: netsim.graph500(cl, **kw))
register_workload("npb",
                  lambda g, cl, kernel="is", klass="A", **kw:
                  netsim.npb(cl, kernel, klass, **kw))
register_workload("traffic",
                  lambda g, cl, pattern="uniform", nbytes=1 << 20, **kw:
                  netsim.traffic_time(cl, pattern, float(nbytes), **kw))


# --------------------------------------------------------------------------------
# run_experiment
# --------------------------------------------------------------------------------

@dataclasses.dataclass
class ExperimentResult:
    """Everything one :func:`run_experiment` call produced.

    ``values[name][key]`` is the workload value for topology ``name``;
    ``seconds[name][key]`` the wall time of that cell; ``graphs``/``specs``
    the built topologies and their provenance specs (None when a ready
    ``Graph`` was passed in).  ``ratios(key)`` divides a reference
    topology's (time-like) value by each topology's — the paper's
    "speedup over ring" convention.
    """

    names: list[str]
    specs: dict[str, TopologySpec | None]
    graphs: dict[str, Graph]
    values: dict[str, dict[str, Any]]
    seconds: dict[str, dict[str, float]]

    def ratios(self, key: str, ref: str | None = None) -> dict[str, float]:
        if ref is None:
            ref = next((n for n in self.names if "Ring" in n), None)
            if ref is None:
                raise ValueError(
                    "no reference topology: no name contains 'Ring' — pass "
                    f"ref= explicitly (names: {', '.join(self.names)})")
        t0 = self.values[ref][key]
        return {n: t0 / self.values[n][key] for n in self.names}

    def provenance(self) -> dict[str, Any]:
        """JSON-able record of what was built: name → spec dict (or None)."""
        return {n: (json.loads(s.to_json()) if s is not None else None)
                for n, s in self.specs.items()}

    def table(self) -> str:
        """Plain-text summary table (names × workload keys)."""
        keys: list[str] = []
        for n in self.names:
            for k in self.values[n]:
                if k not in keys:
                    keys.append(k)
        width = max((len(n) for n in self.names), default=8)
        out = [" " * width + "  " + "  ".join(f"{k:>12s}" for k in keys)]
        for n in self.names:
            cells = []
            for k in keys:
                v = self.values[n].get(k)
                cells.append(f"{v:12.4g}" if isinstance(v, (int, float))
                             else f"{str(v)[:12]:>12s}")
            out.append(f"{n:>{width}s}  " + "  ".join(cells))
        return "\n".join(out)


def _engine_applies(spec: TopologySpec, engine: str, topo_mod) -> bool:
    """Whether a suite-wide ``engine=`` override is meaningful for this
    spec's search tier.  The override is a preference, not a hard
    requirement: only the circulant tier takes an engine (its pricers
    ``numpy``/``torch``), so every other spec keeps its own resolution
    instead of crashing the suite mid-build."""
    if not topo_mod.get_family(spec.family).searched:
        return False
    strategy = str(spec.kwargs.get("strategy", "auto")).replace("_", "-")
    return engine in strategy_engine_domain(strategy)


def _normalize_workload(entry) -> tuple[str, str, dict]:
    """str | (name, params) | (key, name, params) → (key, name, params)."""
    if isinstance(entry, str):
        return entry, entry, {}
    if isinstance(entry, Mapping):
        params = dict(entry)
        name = params.pop("workload")
        return params.pop("key", name), name, params
    entry = tuple(entry)
    if len(entry) == 2:
        name, params = entry
        return name, name, dict(params)
    key, name, params = entry
    return key, name, dict(params)


def _run_cell(
    graph: Graph,
    cluster_factory: Callable[[Graph], "netsim.Cluster"],
    routing: str | None,
    wname: str,
    params: Mapping[str, Any],
    device=None,
) -> tuple[Any, float]:
    """Run one (topology, workload) cell: ``(value, wall_seconds)``.

    The single cell evaluator BOTH the serial loop and the process-pool
    workers call, so the parallel path is bit-identical to serial by
    construction.  Cluster construction is outside the timed region (it is
    a trivial dataclass build — routing tables are computed lazily and
    cached per ``(n, edges)``), matching the historical serial timings.
    In forked workers the cell is looked up by *name*: children inherit
    the parent's workload registry, so even lambda workloads dispatch.
    ``device`` goes only to workloads marked ``needs_device``.
    """
    fn = _WORKLOADS[wname]
    cl = None
    if getattr(fn, "needs_cluster", True):
        cl = cluster_factory(graph)
        if routing is not None:
            cl = dataclasses.replace(cl, routing=routing)
    kw = dict(params)
    if getattr(fn, "needs_device", False):
        kw["device"] = device
    t0 = time.perf_counter()
    value = fn(graph, cl, **kw)
    return value, time.perf_counter() - t0


def _parallel_cells(
    names: list[str],
    graphs_out: Mapping[str, Graph],
    wl: list[tuple[str, str, dict]],
    cluster_factory: Callable,
    routing: str | None,
    jobs: int | None,
    device,
) -> dict[tuple[str, str], tuple[Any, float]] | None:
    """Dispatch the workload × topology grid over a process pool.

    Returns None when the pool cannot be set up at all — no fork start
    method (the registry's lambda workloads only travel by inheritance),
    or unpicklable graphs/factory/params — so the caller falls back to the
    serial loop.  Workload exceptions are NOT swallowed: they propagate
    exactly like the serial path would raise them.  ``device`` is a CPU
    device here: :func:`run_experiment` refuses to fork on a CUDA one.
    """
    import concurrent.futures
    import multiprocessing
    import pickle

    if "fork" not in multiprocessing.get_all_start_methods():
        return None
    try:  # probe the task payloads once, up front
        pickle.dumps((cluster_factory, routing,
                      [graphs_out[n] for n in names],
                      [(key, wname, params) for key, wname, params in wl]))
    except Exception:
        return None
    n_cells = len(names) * len(wl)
    workers = min(jobs or os.cpu_count() or 1, n_cells)
    ctx = multiprocessing.get_context("fork")
    out: dict[tuple[str, str], tuple[Any, float]] = {}
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=max(workers, 1), mp_context=ctx) as pool:
        futs = [((n, key),
                 pool.submit(_run_cell, graphs_out[n], cluster_factory,
                             routing, wname, params, device))
                for n in names for key, wname, params in wl]
        # collect in submission order: result dicts fill exactly like serial
        for cell, fut in futs:
            out[cell] = fut.result()
    return out


def run_experiment(
    topologies: Mapping[str, TopologySpec | str | Graph] | Iterable,
    workloads: Iterable = ("stats",),
    *,
    cache_dir: str | None = None,
    cluster_factory: Callable[[Graph], "netsim.Cluster"] = netsim.TAISHAN,
    engine: str | None = None,
    routing: str | None = None,
    parallel: bool | None = None,
    jobs: int | None = None,
    device=None,
) -> ExperimentResult:
    """Price a suite of topologies through the simulated cluster workloads.

    ``topologies`` maps display names to specs (:class:`TopologySpec`,
    legacy ``family:args`` strings, or ready ``Graph`` objects); an
    iterable of specs works too (names come from the built graphs).  Each
    topology is built once — searched families resolve their strategy
    through the registries and price on ``device`` (``engine=`` forwards one
    circulant pricer, ``"numpy"`` or ``"torch"``, to every searched spec
    whose tier is the circulant one), with optional spec-keyed caching under
    ``cache_dir``.  ``device`` also goes to the workloads that price on the
    device (``stats``); ``None`` is the CUDA device and raises without one,
    ``"cpu"`` runs the kernels' plain versions.

    ``workloads`` entries are registry names (:func:`workload_names`),
    ``(name, params)`` pairs, or ``(key, name, params)`` triples when the
    same workload runs twice with different params.  A routed cluster
    (``cluster_factory``, default the paper's TAISHAN model) is built
    lazily, only when some workload needs one.  ``routing=`` forwards the
    routing tier (``"static"`` / ``"adaptive"``) onto every built cluster,
    overriding whatever the factory set.  Every cell is timed; values,
    wall seconds, graphs, and provenance specs come back in an
    :class:`ExperimentResult`.

    ``parallel=True`` fans the workload × topology grid out over a process
    pool (``jobs`` workers, default the CPU count; forked workers inherit
    the workload registry and the spec build cache is reused across them).
    Values are bit-identical to the serial path — both run the same
    :func:`_run_cell` — and per-cell timings/provenance are preserved; the
    pool silently falls back to serial when it cannot be set up (no fork
    start method, unpicklable graphs/factory/params), while workload
    errors propagate either way.  ``parallel=None`` (the default) reads
    the ``REPRO_PARALLEL`` env var (``"1"`` enables).  A forked child
    cannot use a CUDA device its parent initialised, so ``parallel`` on a
    CUDA device (``device=None`` included) raises ``ValueError`` before
    anything is built; on ``device="cpu"`` it forks as the reference does.
    """
    check_engine(engine, "circulant")
    if parallel is None:
        parallel = os.environ.get("REPRO_PARALLEL", "") == "1"
    if parallel and (device is None or torch.device(device).type == "cuda"):
        raise ValueError(
            "run_experiment(parallel=True) forks worker processes, which "
            "cannot use a CUDA device their parent initialised: run it "
            "serially on the card (parallel=False, REPRO_PARALLEL unset) or "
            "pass device='cpu'")
    wl = [_normalize_workload(w) for w in workloads]
    for _, name, _ in wl:
        if name not in _WORKLOADS:
            raise ValueError(
                f"unknown workload {name!r}: known workloads are "
                f"{', '.join(WORKLOADS)}")

    if isinstance(topologies, Mapping):
        entries = list(topologies.items())
    else:  # iterable: names come from the built graphs
        entries = [(None, t) for t in topologies]
    names: list[str] = []
    specs: dict[str, TopologySpec | None] = {}
    graphs_out: dict[str, Graph] = {}
    from .core import topologies as topo_mod

    for disp, t in entries:
        spec: TopologySpec | None = None
        if isinstance(t, str):
            t = parse_topology(t)
        if isinstance(t, TopologySpec):
            if engine is not None and "engine" not in t.kwargs \
                    and _engine_applies(t, engine, topo_mod):
                t = t.with_params(engine=engine)
            spec = t
            g = build_topology(t, cache_dir=cache_dir, device=device)
        else:
            g = t
        name = disp if disp is not None else g.name
        if name in graphs_out:
            raise ValueError(
                f"duplicate topology name {name!r}: pass a mapping with "
                "distinct display names")
        names.append(name)
        specs[name] = spec
        graphs_out[name] = g

    values: dict[str, dict[str, Any]] = {n: {} for n in names}
    seconds: dict[str, dict[str, float]] = {n: {} for n in names}
    cells = None
    if parallel and len(names) * len(wl) > 1:
        cells = _parallel_cells(names, graphs_out, wl, cluster_factory,
                                routing, jobs, device)
    if cells is not None:
        for n in names:
            for key, _, _ in wl:
                values[n][key], seconds[n][key] = cells[(n, key)]
    else:  # serial path (also the parallel-setup fallback)
        for n in names:
            for key, wname, params in wl:
                values[n][key], seconds[n][key] = _run_cell(
                    graphs_out[n], cluster_factory, routing, wname, params,
                    device)
    return ExperimentResult(names=names, specs=specs, graphs=graphs_out,
                            values=values, seconds=seconds)


# --------------------------------------------------------------------------------
# CLI — `python -m repro_torch.api spec.json` runs one experiment end to end and
# writes the ExperimentResult as JSON: the one-shot replayable surface the
# ROADMAP experiment-service item asks for.  The spec file is exactly the
# provenance dicts the benchmarks embed, so any BENCH_*.json row replays.
# --------------------------------------------------------------------------------

def _json_default(o):
    """JSON fallback for workload values: dataclasses (CollectiveReport,
    SearchResult, ...) and ``__slots__`` records (GraphStats) → dicts,
    numpy scalars/arrays → python."""
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return dataclasses.asdict(o)
    if hasattr(o, "item") and getattr(o, "shape", None) == ():
        return o.item()
    if hasattr(o, "tolist"):
        return o.tolist()
    slots = getattr(type(o), "__slots__", None)
    if slots:  # e.g. metrics.GraphStats — str(o) would be a memory address
        return {s: getattr(o, s) for s in slots if hasattr(o, s)}
    return str(o)


def main(argv: list[str] | None = None) -> int:
    """Entry point for ``python -m repro_torch.api``.

    The spec file is a JSON object with either ``"suite"`` (a
    :func:`paper_suite` key) or ``"topologies"`` (name → TopologySpec dict or
    legacy ``family:args`` string, or a plain list of either), plus
    ``"workloads"`` (registry names, ``[name, params]`` pairs, or
    ``{"workload": name, ...params}`` dicts) and optional ``"engine"`` /
    ``"cache_dir"`` / ``"routing"`` (``"static"`` / ``"adaptive"``) /
    ``"parallel"`` / ``"jobs"``.  The result JSON carries names, values,
    wall seconds, provenance specs, and the plain-text table.

    A malformed spec exits non-zero with the offending key named in the
    message and writes nothing: the output file is written atomically
    (tmp + rename), so a failed run can never leave a half-written table
    behind.  ``--device`` is where the experiment prices (the card unless
    ``--device cpu``); it is not part of the spec file.
    """
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="Run one repro experiment from a spec JSON file.")
    p.add_argument("spec", help="path to the experiment spec JSON")
    p.add_argument("-o", "--output", default=None,
                   help="write result JSON here (default: stdout)")
    p.add_argument("--device", default=None,
                   help="where to price: the CUDA device unless 'cpu'")
    args = p.parse_args(argv)
    try:
        with open(args.spec) as f:
            d = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        raise SystemExit(f"cannot read spec {args.spec!r}: {exc}") from exc
    if not isinstance(d, Mapping):
        raise SystemExit(
            f"spec JSON must be an object, got {type(d).__name__}")
    known = ("suite", "topologies", "workloads", "engine", "cache_dir",
             "routing", "parallel", "jobs")
    unknown = sorted(set(d) - set(known))
    if unknown:
        raise SystemExit(
            f"unknown spec key(s) {', '.join(map(repr, unknown))}: known "
            f"keys are {', '.join(known)}")

    def _topo(v):
        return TopologySpec.from_json(v) if isinstance(v, Mapping) else v

    if "suite" in d:
        topologies = paper_suite(str(d["suite"]))
    else:
        raw = d.get("topologies")
        if raw is None:
            raise SystemExit("spec JSON needs 'suite' or 'topologies'")
        topologies = {k: _topo(v) for k, v in raw.items()} \
            if isinstance(raw, Mapping) else [_topo(v) for v in raw]
    workloads = [tuple(w) if isinstance(w, list) else w
                 for w in d.get("workloads") or ["stats"]]
    try:
        exp = run_experiment(
            topologies, workloads=workloads, engine=d.get("engine"),
            cache_dir=d.get("cache_dir"), routing=d.get("routing"),
            parallel=d.get("parallel"),
            jobs=int(d["jobs"]) if d.get("jobs") is not None else None,
            device=args.device)
    except (ValueError, KeyError, TypeError) as exc:
        # bad registry names / malformed workload entries: a clean non-zero
        # exit naming the offender, not a traceback over a partial table
        raise SystemExit(f"bad experiment spec {args.spec!r}: {exc}") from exc
    out = {"names": exp.names, "values": exp.values, "seconds": exp.seconds,
           "provenance": exp.provenance(), "table": exp.table()}
    text = json.dumps(out, indent=2, sort_keys=True, default=_json_default)
    if args.output:
        tmp = args.output + ".tmp"
        with open(tmp, "w") as f:
            f.write(text + "\n")
        os.replace(tmp, args.output)
    else:
        print(text)
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess test
    raise SystemExit(main())
