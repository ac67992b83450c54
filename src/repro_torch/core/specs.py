"""Declarative specs + the search-strategy registry (the counterpart of
``repro.core.specs``).

This module is one half of the unified API layer (the other half is
``repro_torch.core.topologies``, the topology-family registry;
``repro_torch.api`` is the facade over both):

- :class:`TopologySpec` — a frozen, hashable, JSON-round-trippable
  description of *which graph to build* (family name + params + seed).  The
  family names it may carry are validated by
  ``repro_torch.core.topologies``.
- :class:`SearchSpec` — the same for *which search to run*: (n, k,
  objective, strategy, budget, fold, replicas, engine, seed) plus free-form
  strategy params.  ``search(spec)`` is the single dispatch that replaced
  ``find_optimal``'s if-ladder.
- the **strategy registry**: each search tier (``pinned`` / ``exhaustive`` /
  ``sa`` / ``circulant`` / ``symmetric-sa`` / ``large``) registers a
  :class:`SearchStrategy` adapter.  ``strategy="auto"`` resolves by N-tier with
  the same policy the legacy ``find_optimal`` driver used (pinned edge list
  → parallel-replica SA at n <= 64 → the circulant+polish large tier), so
  the legacy driver is now a thin, trajectory-identical shim over
  :func:`search`.
- the **objective registry**: what the search *minimises*.  ``mpl`` (the
  paper's objective) is handled natively by every strategy tier; other
  objectives (``collective-time`` built in) register an adapter that owns
  the whole run, and ``search()`` dispatches to it before any strategy
  resolution — so new objectives are a spec field plus one
  :func:`register_objective` call, not a new entry point.

Contract: ``search(SearchSpec(n, k, strategy=X, budget=B, seed=S, ...))`` is
byte-identical per seed to the legacy ``find_optimal(n, k, method=X,
budget=B, seed=S)`` branch it replaced, and every spec round-trips through
JSON without changing the resulting graph/trajectory — which is what makes
the ``spec`` provenance rows embedded in ``BENCH_search.json`` replayable.
The port's results equal the reference's for the same spec
(``tests/test_torch_specs_api.py``).

Where the port differs: the device is a keyword, never a spec field.
``search(spec, device=None)`` hands it to every strategy and objective
adapter (``run(spec, device)``); the tiers that price on a device
(``circulant``, ``symmetric-sa``, ``large``) take it, the host tiers ignore
it.  ``None`` is the CUDA device (the tier raises without one), ``"cpu"``
runs the kernels' plain versions; the graphs are the same either way, so a
spec's JSON, its hash and the build cache do not depend on the device.
``SearchSpec.engine`` stays a field so the reference's spec JSON loads, but
it accepts only ``None``/``"auto"`` and, for the circulant strategy, the
port's pricers ``"numpy"`` and ``"torch"``; anything else raises
``ValueError``.
"""
from __future__ import annotations

import dataclasses
import json
import numbers
from typing import Any, Callable, Iterable, Mapping

__all__ = [
    "TopologySpec",
    "SearchSpec",
    "SearchStrategy",
    "register_strategy",
    "search_strategies",
    "resolve_strategy",
    "strategy_engine_domain",
    "check_engine",
    "Objective",
    "register_objective",
    "objective_names",
    "resolve_objective",
    "search",
]


# --------------------------------------------------------------------------------
# Canonicalisation: params live in frozen dataclasses, so they are stored as
# sorted (key, value) tuples with lists coerced to tuples — hashable, order
# independent, and loss-lessly convertible to/from JSON dicts.
# --------------------------------------------------------------------------------

def _freeze(value):
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, Mapping):
        return tuple(sorted((str(k), _freeze(v)) for k, v in value.items()))
    if isinstance(value, (str, bytes, bool, type(None))):
        return value
    # numbers.Integral/Real catch numpy scalars too (np.int64 is NOT a
    # subclass of int) -> plain python ints/floats, so specs JSON-dump
    if isinstance(value, numbers.Integral):
        return int(value)
    if isinstance(value, numbers.Real):
        return float(value)
    return value


def _thaw(value):
    if isinstance(value, tuple):
        return [_thaw(v) for v in value]
    return value


def _params_tuple(params: Mapping[str, Any] | Iterable | None) -> tuple:
    if params is None:
        return ()
    if isinstance(params, Mapping):
        items = params.items()
    else:
        items = tuple(params)
        items = [(k, v) for k, v in items]
    return tuple(sorted((str(k), _freeze(v)) for k, v in items))


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Declarative description of a topology: family + params + seed.

    ``params`` accepts a dict at construction and is stored canonically
    (sorted key/value tuples, lists frozen to tuples), so specs are hashable
    and equal iff they describe the same graph.  ``seed`` only matters for
    stochastic families (searched/random graphs) and defaults to 0.

    Round trip: ``TopologySpec.from_json(spec.to_json())`` == ``spec`` and
    builds the identical ``Graph`` (asserted in tests/test_specs.py).
    """

    family: str
    params: tuple = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "family", str(self.family).replace("_", "-"))
        object.__setattr__(self, "params", _params_tuple(self.params))
        object.__setattr__(self, "seed", int(self.seed))

    @classmethod
    def make(cls, family: str, seed: int = 0, **params) -> "TopologySpec":
        return cls(family=family, params=params, seed=seed)

    @property
    def kwargs(self) -> dict[str, Any]:
        """The params as a plain dict (tuples preserved for hashability)."""
        return {k: v for k, v in self.params}

    def with_params(self, **params) -> "TopologySpec":
        """A copy with ``params`` merged in (None values remove keys)."""
        merged = self.kwargs
        for k, v in params.items():
            if v is None:
                merged.pop(k, None)
            else:
                merged[k] = v
        return TopologySpec(self.family, merged, self.seed)

    def to_json(self) -> str:
        return json.dumps(
            {"family": self.family, "seed": self.seed,
             "params": {k: _thaw(v) for k, v in self.params}},
            sort_keys=True)

    @classmethod
    def from_json(cls, data: str | Mapping[str, Any]) -> "TopologySpec":
        d = json.loads(data) if isinstance(data, str) else dict(data)
        return cls(family=d["family"], params=d.get("params") or {},
                   seed=d.get("seed", 0))


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """Declarative description of a topology search.

    Core knobs every tier understands are first-class fields; anything
    strategy-specific (``target_mpl``, ``start_offsets``, ``incremental``,
    ``moves_per_step``, ``girth_min`` …) rides in ``params`` and is forwarded
    to the strategy's underlying entry point verbatim.  ``engine`` names a
    pricer of the circulant strategy (:func:`check_engine`).  ``warm_start=True``
    in ``params`` seeds the SA tiers from the certified best-known-graph
    table when a ``(n, k)`` entry matches (``core.certify``); the
    default stays cold so per-seed trajectories are unchanged.  ``budget`` maps onto
    each tier's natural budget knob (``n_iter`` for the SA tiers, ``limit``
    for the exhaustive tier, the two-stage budget for ``large``).

    ``strategy="auto"`` resolves by N-tier exactly like the legacy
    ``find_optimal`` driver; ``objective`` names an entry in the objective
    registry (``"mpl"`` — the paper's objective, handled natively by every
    strategy tier — or ``"collective-time"``, which owns its own run; see
    :func:`register_objective`).  The reserved ``graph_name`` param renames
    the result graph after the run (how the auto-SA tier pins its
    ``(n,k)-Optimal`` naming without a special case in the strategy).
    """

    n: int
    k: int
    objective: str = "mpl"
    strategy: str = "auto"
    budget: int | None = None
    fold: int | None = None
    replicas: int | None = None
    engine: str | None = None
    seed: int = 0
    params: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "n", int(self.n))
        object.__setattr__(self, "k", int(self.k))
        strategy = str(self.strategy or "auto").replace("_", "-")
        # legacy find_optimal alias, honoured everywhere specs are built
        strategy = {"symmetric": "symmetric-sa"}.get(strategy, strategy)
        object.__setattr__(self, "strategy", strategy)
        object.__setattr__(
            self, "objective", str(self.objective or "mpl").replace("_", "-"))
        object.__setattr__(self, "params", _params_tuple(self.params))
        object.__setattr__(self, "seed", int(self.seed))
        for f in ("budget", "fold", "replicas"):  # numpy ints -> python ints
            v = getattr(self, f)
            if v is not None:
                object.__setattr__(self, f, int(v))

    @classmethod
    def make(cls, n: int, k: int, **kw) -> "SearchSpec":
        fields = {f.name for f in dataclasses.fields(cls)} - {"params"}
        params = {k_: v for k_, v in kw.items() if k_ not in fields}
        core = {k_: v for k_, v in kw.items() if k_ in fields}
        return cls(n=n, k=k, params=params, **core)

    @property
    def kwargs(self) -> dict[str, Any]:
        return {k: v for k, v in self.params}

    def with_overrides(self, **kw) -> "SearchSpec":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["params"] = {k: _thaw(v) for k, v in self.params}
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, data: str | Mapping[str, Any]) -> "SearchSpec":
        d = json.loads(data) if isinstance(data, str) else dict(data)
        return cls(**{**d, "params": d.get("params") or {}})


# --------------------------------------------------------------------------------
# Strategy registry — search tiers register here; the registry is the single
# strategy-name validation point and owns the auto N-tier policy.
# --------------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchStrategy:
    """One registered search tier: a name, the adapter that maps a
    :class:`SearchSpec` and a device onto the tier's entry point
    (``run(spec, device)``), and a doc line for the registry tables."""

    name: str
    run: Callable[[SearchSpec, Any], "Any"]
    doc: str = ""


_STRATEGIES: dict[str, SearchStrategy] = {}

#: registered strategy names, in registration order (extended live by
#: :func:`register_strategy`, so out-of-tree strategies resolve like the
#: built-ins)
STRATEGIES: tuple[str, ...] = ()


def register_strategy(name: str, run: Callable, doc: str = "",
                      replace: bool = False) -> SearchStrategy:
    """Register a search strategy under ``name``.

    Re-registering an existing strategy raises unless ``replace=True``
    (same contract as ``register_topology`` / ``register_objective``).
    """
    global STRATEGIES
    strat = SearchStrategy(name=name, run=run, doc=doc)
    if name in _STRATEGIES and not replace:
        raise ValueError(
            f"strategy {name!r} is already registered; pass replace=True "
            "to override it")
    _STRATEGIES[name] = strat
    if name not in STRATEGIES:
        STRATEGIES = STRATEGIES + (name,)
    return strat


def search_strategies() -> tuple[str, ...]:
    """Registered strategy names (the validation universe for ``strategy=``)."""
    return STRATEGIES


def get_strategy(name: str) -> SearchStrategy:
    strat = _STRATEGIES.get(str(name).replace("_", "-"))
    if strat is None:
        raise ValueError(
            f"strategy={name!r} must be one of {STRATEGIES + ('auto',)}")
    return strat


# --------------------------------------------------------------------------------
# Objective registry — what the search minimises.  ``mpl`` is the native
# objective every strategy tier understands; any other registered objective
# carries its own run adapter and ``search()`` dispatches to it *instead of*
# strategy resolution (the adapter owns budget/seed semantics).
# --------------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Objective:
    """One registered search objective: a name, an optional adapter that owns
    the whole run for a :class:`SearchSpec` and a device (``run(spec,
    device)``; ``None`` means the strategy tiers minimise it natively, i.e.
    ``mpl``), and a doc line for the registry tables."""

    name: str
    run: Callable[[SearchSpec, Any], "Any"] | None = None
    doc: str = ""


_OBJECTIVES: dict[str, Objective] = {}

#: registered objective names, in registration order (extended live by
#: :func:`register_objective`, so out-of-tree objectives resolve like the
#: built-ins)
OBJECTIVES: tuple[str, ...] = ()


def register_objective(name: str, run: Callable | None = None,
                       doc: str = "", replace: bool = False) -> Objective:
    """Register a search objective under ``name``.

    ``run=None`` marks a native objective: the strategy tiers minimise it
    themselves and :func:`search` goes through strategy resolution as usual.
    A non-None ``run`` owns the whole search for its spec and must return a
    ``SearchResult``.  Re-registering an existing objective raises unless
    ``replace=True``.
    """
    global OBJECTIVES
    obj = Objective(name=name, run=run, doc=doc)
    if name in _OBJECTIVES and not replace:
        raise ValueError(
            f"objective {name!r} is already registered; pass replace=True "
            "to override it")
    _OBJECTIVES[name] = obj
    if name not in OBJECTIVES:
        OBJECTIVES = OBJECTIVES + (name,)
    return obj


def objective_names() -> tuple[str, ...]:
    """Registered objective names (the validation universe for ``objective=``)."""
    return OBJECTIVES


def get_objective(name: str) -> Objective:
    obj = _OBJECTIVES.get(str(name).replace("_", "-"))
    if obj is None:
        raise ValueError(f"objective={name!r} must be one of {OBJECTIVES}")
    return obj


def resolve_objective(spec: SearchSpec) -> Objective:
    """Validate ``spec.objective`` against the registry → :class:`Objective`."""
    return get_objective(spec.objective)


def resolve_strategy(spec: SearchSpec) -> SearchSpec:
    """Validate ``spec`` and resolve ``strategy="auto"`` by N-tier.

    The auto policy is byte-identical to the legacy ``find_optimal`` ladder:
    a pinned edge list in ``known_optimal`` wins instantly, n <= 64 runs the
    parallel-replica SA tier, anything larger the circulant+polish large
    tier.  Returns a spec whose ``strategy`` is a concrete registered name;
    its ``engine`` must belong to that strategy (:func:`check_engine`).
    """
    resolve_objective(spec)  # loud ValueError on unknown objectives
    if spec.strategy != "auto":
        get_strategy(spec.strategy)  # loud ValueError on unknown names
    else:
        from .known_optimal import KNOWN_EDGE_LISTS

        if (spec.n, spec.k) in KNOWN_EDGE_LISTS:
            spec = spec.with_overrides(strategy="pinned")
        else:
            spec = spec.with_overrides(strategy="sa" if spec.n <= 64 else "large")
    check_engine(spec.engine, spec.strategy)
    return spec


def strategy_engine_domain(strategy: str) -> tuple[str, ...]:
    """Engine-name vocabulary a search strategy prices with.

    The circulant tier takes the port's candidate-batch pricers
    (``search.CIRCULANT_ENGINES``: ``"numpy"`` and ``"torch"``); every
    other tier prices on the device it is given and takes no engine, so its
    domain is empty.  Callers must not branch on engine/strategy name
    literals themselves.
    """
    if strategy == "circulant":
        from .search import CIRCULANT_ENGINES  # lazy: search imports torch

        return CIRCULANT_ENGINES
    return ()


def check_engine(engine: str | None, strategy: str) -> None:
    """Refuse an ``engine`` the port's ``strategy`` does not take.

    ``None`` and ``"auto"`` pass everywhere.  The reference's row engines
    (``c``, ``numpy``, ``bitset``, ``pallas``) and its ``"jax"`` circulant
    pricer have no counterpart, since the port picks where to price from
    ``device``: such a name raises ``ValueError`` rather than being ignored.
    """
    if engine in (None, "auto") or engine in strategy_engine_domain(strategy):
        return
    raise ValueError(
        f"engine={engine!r} is not an engine of the {strategy!r} strategy in "
        f"repro_torch: only the circulant strategy takes one "
        f"{strategy_engine_domain('circulant')}; the reference's row "
        f"engines and its 'jax' pricer have no counterpart here, where "
        f"device= picks the card or the CPU")


def search(spec: SearchSpec, device=None):
    """Run the search a :class:`SearchSpec` describes → ``SearchResult``.

    This is the single paper-facing dispatch: the objective resolves first
    (a non-native objective's adapter owns the whole run); otherwise strategy
    names are validated against the registry, ``auto`` resolves by N-tier,
    and the selected adapter maps the spec onto its tier's entry point with
    the exact legacy defaults — so ``search(spec)`` with ``objective="mpl"``
    reproduces the corresponding ``find_optimal(method=...)`` trajectory
    bit-for-bit per seed.  ``device`` goes to the adapter: ``None`` is the
    CUDA device, ``"cpu"`` the kernels' plain versions.
    """
    obj = resolve_objective(spec)
    if obj.run is not None:
        res = obj.run(spec, device)
    else:
        spec = resolve_strategy(spec)
        res = get_strategy(spec.strategy).run(spec, device)
    name = spec.kwargs.get("graph_name")
    if name:
        res.graph = res.graph.with_name(str(name))
    return res


# --------------------------------------------------------------------------------
# Built-in strategy adapters.  Each maps SearchSpec fields onto one legacy
# entry point with that branch's historical defaults; spec.params pass
# through verbatim (so target_mpl / start_offsets / incremental / ... stay
# reachable).  The underlying functions keep their signatures — they ARE the
# implementations; the adapters only translate.  The host tiers (pinned,
# exhaustive, sa) ignore the device.
# --------------------------------------------------------------------------------

def _strip(kw: dict, *reserved: str) -> dict:
    out = dict(kw)
    for r in ("graph_name", "warm_start") + reserved:
        out.pop(r, None)
    return out


def _warm_start_entry(spec: SearchSpec):
    """The certified table entry seeding a warm-started run, or None.

    Only consulted when the spec carries ``warm_start=True`` in params —
    the default stays cold so existing search trajectories are untouched
    (the maintenance invariant: bit-identical per seed).
    """
    if not spec.kwargs.get("warm_start"):
        return None
    from . import certify

    return certify.get_entry(spec.n, spec.k)


def _run_pinned(spec: SearchSpec, device=None):
    from . import metrics, search as search_mod
    from .graphs import from_edges
    from .known_optimal import KNOWN_EDGE_LISTS

    edges = KNOWN_EDGE_LISTS.get((spec.n, spec.k))
    if edges is None:
        raise ValueError(
            f"no pinned edge list for ({spec.n},{spec.k}) in known_optimal")
    g = from_edges(spec.n, edges, f"({spec.n},{spec.k})-Optimal")
    mpl, diam = search_mod._graph_mpl_d(g)
    return search_mod.SearchResult(
        graph=g, mpl=mpl, diameter=diam,
        mpl_lb=metrics.mpl_lower_bound(spec.n, spec.k),
        d_lb=metrics.diameter_lower_bound(spec.n, spec.k),
        iterations=0, accepted=0, history=[mpl])


def _run_exhaustive(spec: SearchSpec, device=None):
    from . import search as search_mod

    return search_mod.exhaustive_search(
        spec.n, spec.k, limit=spec.budget or 200_000, **_strip(spec.kwargs))


def _run_sa(spec: SearchSpec, device=None):
    from . import search as search_mod

    kw = _strip(spec.kwargs)
    if "target_mpl" not in kw:
        kw["target_mpl"] = search_mod.KNOWN_OPTIMAL_MPL.get((spec.n, spec.k))
    if "start" not in kw:
        entry = _warm_start_entry(spec)
        if entry is not None:
            from . import certify

            kw["start"] = certify.build_entry_graph(entry)
    res = search_mod.sa_search(
        spec.n, spec.k, seed=spec.seed, n_iter=spec.budget or 4000,
        replicas=spec.replicas or (3 if spec.n <= 40 else 2), **kw)
    if "graph_name" not in spec.kwargs:  # the legacy paper-facing naming
        res.graph = res.graph.with_name(f"({spec.n},{spec.k})-Optimal")
    return res


def _run_circulant(spec: SearchSpec, device=None):
    from . import search as search_mod

    return search_mod.circulant_search(
        spec.n, spec.k, seed=spec.seed, n_iter=spec.budget or 300,
        engine=spec.engine or "auto", device=device, **_strip(spec.kwargs))


def _run_symmetric_sa(spec: SearchSpec, device=None):
    from . import search as search_mod

    kw = _strip(spec.kwargs)
    if "start_offsets" in kw and kw["start_offsets"] is not None:
        kw["start_offsets"] = tuple(kw["start_offsets"])
    if kw.get("start_offsets") is None:
        entry = _warm_start_entry(spec)
        if entry is not None and entry.get("offsets") is not None:
            kw["start_offsets"] = tuple(int(o) for o in entry["offsets"])
    return search_mod.symmetric_sa_search(
        spec.n, spec.k, seed=spec.seed, n_iter=spec.budget or 3000,
        fold=spec.fold if spec.fold is not None else 4,
        device=device, **kw)


def _run_large(spec: SearchSpec, device=None):
    from . import search as search_mod

    return search_mod.large_search(
        spec.n, spec.k, seed=spec.seed, budget=spec.budget,
        fold=spec.fold if spec.fold is not None else 4,
        replicas=spec.replicas or 1, device=device,
        **_strip(spec.kwargs))


register_strategy(
    "pinned", _run_pinned,
    "return the pre-searched edge list pinned in known_optimal (exact)")
register_strategy(
    "exhaustive", _run_exhaustive,
    "enumerate ring+chord graphs, k=3 matching chords (tiny N, exact)")
register_strategy(
    "sa", _run_sa,
    "paper Algorithm 1: parallel-replica SA with incremental APSP (N <= ~128)")
register_strategy(
    "circulant", _run_circulant,
    "offset-set hillclimb over circulants, implicit-BFS priced (N to 16384)")
register_strategy(
    "symmetric-sa", _run_symmetric_sa,
    "orbit-level SA under fold-fold rotational symmetry, SymmetricAPSP priced")
register_strategy(
    "large", _run_large,
    "pinned-or-searched circulant warm start + orbit-SA polish (replica-sharded "
    "when replicas > 1)")


# --------------------------------------------------------------------------------
# Built-in objectives.  ``mpl`` is native (the strategy tiers minimise it
# themselves); ``collective-time`` closes the paper's co-design loop — SA over
# edge swaps scoring each candidate graph by its *synthesized* collective
# schedule time on the netsim cluster (repro_torch.comm.schedules).
# --------------------------------------------------------------------------------

def _run_collective_time(spec: SearchSpec, device=None):
    """SA edge-swap search minimising synthesized collective-schedule time.

    Spec params: ``op`` (default ``"allreduce"``, any ``schedules.SYNTH_OPS``
    member), ``unit_bytes`` (default 256 KiB — latency/bandwidth mixed regime
    where schedule structure matters), ``model`` is the netsim TAISHAN link.
    The SA score is the synthesized time normalised by the ring baseline (so
    the legacy temperature schedule transfers), plus a tiny (1e-3) mean-of-
    candidates guidance term that gives the annealer gradient across the
    flat ring plateau without ever distorting which graph wins.  The whole
    run is on the host, so ``device`` is not used.
    """
    from . import collectives as C, metrics, search as search_mod
    from .graphs import ring
    from .routing import RoutingTable
    from ..comm import schedules

    kw = spec.kwargs
    op = str(kw.get("op", "allreduce"))
    unit = float(kw.get("unit_bytes", 1 << 18))
    if op not in schedules.SYNTH_OPS:
        raise ValueError(
            f"op={op!r} must be one of {sorted(schedules.SYNTH_OPS)}")
    base = schedules.synthesize(ring(spec.n), op, unit).time

    def score(g) -> float:
        syn = schedules.synthesize(g, op, unit, rt=RoutingTable.build(g))
        guide = sum(syn.candidates.values()) / max(len(syn.candidates), 1) \
            if syn.candidates else syn.time
        return (syn.time + 1e-3 * guide) / base

    g = search_mod.sa_objective_search(
        spec.n, spec.k, score, seed=spec.seed, n_iter=spec.budget or 600)
    if "graph_name" not in kw:
        g = g.with_name(f"({spec.n},{spec.k})-CollectiveOpt")
    syn = schedules.synthesize(g, op, unit, rt=RoutingTable.build(g))
    mpl, diam = search_mod._graph_mpl_d(g)
    return search_mod.SearchResult(
        graph=g, mpl=mpl, diameter=diam,
        mpl_lb=metrics.mpl_lower_bound(spec.n, spec.k),
        d_lb=metrics.diameter_lower_bound(spec.n, spec.k),
        iterations=spec.budget or 600, accepted=0, history=[syn.time],
        objective_value=syn.time)


register_objective(
    "mpl", None,
    "mean path length — the paper's objective, minimised natively by every "
    "strategy tier")
register_objective(
    "collective-time", _run_collective_time,
    "synthesized collective-schedule time on the netsim cluster "
    "(sa_objective_search over repro_torch.comm.schedules)")
