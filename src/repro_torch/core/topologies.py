"""Topology-family registry: the single place family names are validated
(the counterpart of ``repro.core.topologies``).

The other half of the unified API layer (specs live in
``repro_torch.core.specs``; ``repro_torch.api`` is the facade).  Every
buildable graph family registers a :class:`TopologyFamily` here —
constructors from ``repro_torch.core.graphs`` as well as the *searched*
families (``optimal`` / ``suboptimal``) that price a
:class:`~repro_torch.core.specs.SearchSpec` through
``repro_torch.core.specs.search`` — so adding a family is a registration,
not a new ``if`` branch:

======================== ======================================== =========
family                    params                                  searched
======================== ======================================== =========
ring                      n                                       no
complete                  n                                       no
wagner                    n (even)                                no
bidiakis                  n (12 or n % 8 == 0)                    no
chvatal                   —  (the 12-vertex Chvátal graph)        no
chvatal32                 —  (the paper's 32-vertex variant)      no
petersen                  —                                       no
circulant                 n, offsets                              no
torus                     dims                                    no
hypercube                 dim                                     no
dragonfly                 a, g?, h?                               no
random-regular            n, k  (+ spec.seed)                     no
random-hamiltonian-regular n, k (+ spec.seed)                     no
cluster-hub               clusters, size, inner?, outer?          no
nested                    outer, inner (string specs), hub?       no
optimal                   n, k, strategy?, budget?, … (+ seed)    yes
suboptimal                n, k, n_iter?, fold?      (+ seed)      yes
======================== ======================================== =========

:func:`build_topology` accepts a :class:`~repro_torch.core.specs.TopologySpec`, a
legacy ``family:args`` string (the full ``graphs.build`` grammar, e.g.
``ring:16`` / ``torus:4x8`` / ``circulant:32:1,7`` / ``dragonfly:4,5,1`` /
``optimal:16,3``), or an already-built ``Graph``; unknown families raise a
``ValueError`` that lists every registered name.  :func:`paper_suite`
returns the paper's benchmark suites as name → spec dicts, an equal copy
of the reference's data.

Where the port differs: a family's builder takes the device as well,
``build(spec, device)``, and :func:`build_topology` takes ``device=None``.
The searched families hand it to ``specs.search`` (``None`` is the CUDA
device, ``"cpu"`` the kernels' plain versions) and ``nested`` to its parts;
the constructive families ignore it.  The graph does not depend on the
device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from . import graphs
from .graphs import Graph
from .specs import TopologySpec

__all__ = [
    "TopologyFamily",
    "register_topology",
    "topology_families",
    "get_family",
    "parse_topology",
    "build_topology",
    "paper_suite",
    "PAPER_SUITES",
]


@dataclasses.dataclass(frozen=True)
class TopologyFamily:
    """One registered family: name, builder, string-spec parser, doc line.

    ``build`` maps a validated :class:`TopologySpec` and a device to a
    ``Graph``;
    ``parse`` maps the ``:``-separated args of a string spec to a params
    dict (None → the family takes no string args).  ``searched`` marks
    families whose construction runs a (seeded) search — the ones worth
    caching by spec hash (see ``repro_torch.api.build_topology``).
    """

    name: str
    build: Callable[[TopologySpec, Any], Graph]
    parse: Callable[[list[str]], dict] | None = None
    doc: str = ""
    searched: bool = False


_REGISTRY: dict[str, TopologyFamily] = {}

#: registered family names, in registration order — extended live by
#: :func:`register_topology`, so out-of-tree families resolve like built-ins
FAMILIES: tuple[str, ...] = ()


def register_topology(
    name: str,
    build: Callable[[TopologySpec, Any], Graph],
    parse: Callable[[list[str]], dict] | None = None,
    doc: str = "",
    searched: bool = False,
    replace: bool = False,
) -> TopologyFamily:
    """Register a topology family under ``name``.

    Re-registering an existing family raises unless ``replace=True`` — a
    silent overwrite would let an extension shadow a built-in (or another
    extension) without anyone noticing until graphs come out wrong.
    """
    global FAMILIES
    fam = TopologyFamily(name=name, build=build, parse=parse, doc=doc,
                         searched=searched)
    if fam.name in _REGISTRY and not replace:
        raise ValueError(
            f"topology family {fam.name!r} is already registered; pass "
            "replace=True to override it")
    _REGISTRY[fam.name] = fam
    if fam.name not in FAMILIES:
        FAMILIES = FAMILIES + (fam.name,)
    return fam


def topology_families() -> tuple[str, ...]:
    """Registered family names (the validation universe for specs)."""
    return FAMILIES


def get_family(name: str) -> TopologyFamily:
    """Validated registry lookup — ValueError lists every known family."""
    fam = _REGISTRY.get(str(name).replace("_", "-"))
    if fam is None:
        raise ValueError(
            f"unknown topology family {name!r}: known families are "
            f"{', '.join(FAMILIES)}")
    return fam


def parse_topology(spec: str, **kw) -> TopologySpec:
    """Parse a legacy ``family:args`` string into a :class:`TopologySpec`.

    ``kw`` overrides/extends the parsed params; ``seed=`` and the legacy
    ``method=`` (→ ``strategy``) keys map onto their spec fields.  This is
    the only string-spec parser — ``graphs.build`` delegates here.
    """
    parts = str(spec).split(":")
    fam = get_family(parts[0])
    params = fam.parse(parts[1:]) if fam.parse is not None else {}
    if fam.parse is None and len(parts) > 1:
        raise ValueError(f"family {fam.name!r} takes no spec args: {spec!r}")
    seed = kw.pop("seed", 0)
    if "method" in kw:  # legacy find_optimal passthrough knob
        kw["strategy"] = kw.pop("method") or "auto"
    params.update(kw)
    return TopologySpec(family=fam.name, params=params, seed=seed)


def normalize_topology(spec: TopologySpec | str, **kw) -> TopologySpec:
    """Canonicalise a spec-or-string plus keyword overrides into one
    :class:`TopologySpec` (``seed=`` maps onto the seed field, the legacy
    ``method=`` onto ``strategy``).  The single normalisation point — both
    ``build_topology`` here and the caching
    ``repro_torch.api.build_topology``
    run through it, so overrides behave identically on every path."""
    if isinstance(spec, str):
        return parse_topology(spec, **kw)
    if kw:
        seed = kw.pop("seed", None)
        if "method" in kw:
            kw["strategy"] = kw.pop("method") or "auto"
        spec = spec.with_params(**kw)
        if seed is not None:
            spec = dataclasses.replace(spec, seed=int(seed))
    return spec


def build_topology(spec: TopologySpec | str | Graph, device=None,
                   **kw) -> Graph:
    """Build a topology from a spec object, a ``family:args`` string, or a
    ready ``Graph`` (returned unchanged) — the single build entry point.
    ``device`` is where a searched family prices (``None``: the CUDA
    device; ``"cpu"``: the kernels' plain versions)."""
    if isinstance(spec, Graph):
        return spec
    spec = normalize_topology(spec, **kw)
    return get_family(spec.family).build(spec, device)


# --------------------------------------------------------------------------------
# Built-in families
# --------------------------------------------------------------------------------

def _req(spec: TopologySpec, key: str):
    kw = spec.kwargs
    if key not in kw:
        raise ValueError(
            f"family {spec.family!r} requires param {key!r} (got "
            f"{sorted(kw) or 'none'})")
    return kw[key]


def _int_arg(parts: list[str], fam: str) -> dict:
    if len(parts) != 1:
        raise ValueError(f"family {fam!r} spec needs exactly one arg, e.g. '{fam}:16'")
    return {"n": int(parts[0])}


register_topology(
    "ring", lambda s, _dev: graphs.ring(int(_req(s, "n"))),
    parse=lambda p: _int_arg(p, "ring"), doc="(N,2) Hamiltonian cycle")
register_topology(
    "complete", lambda s, _dev: graphs.complete(int(_req(s, "n"))),
    parse=lambda p: _int_arg(p, "complete"), doc="K_N")
register_topology(
    "wagner", lambda s, _dev: graphs.wagner(int(_req(s, "n"))),
    parse=lambda p: _int_arg(p, "wagner"),
    doc="Möbius ladder C_N(1, N/2), the paper's (N,3)-Wagner")
register_topology(
    "bidiakis", lambda s, _dev: graphs.bidiakis(int(_req(s, "n"))),
    parse=lambda p: _int_arg(p, "bidiakis"),
    doc="generalized Bidiakis cube (N=12 or N % 8 == 0)")
register_topology(
    "chvatal",
    lambda s, _dev: graphs.chvatal32() if s.kwargs.get("n") == 32 else graphs.chvatal(),
    parse=lambda p: {"n": int(p[0])} if p else {},
    doc="Chvátal graph (12,4); 'chvatal:32' → the paper's (32,4) variant")
register_topology(
    "chvatal32", lambda s, _dev: graphs.chvatal32(),
    doc="the paper's 32-vertex degree-4 'Chvatal' (D=4, MPL=2.55, BW=8)")
register_topology(
    "petersen", lambda s, _dev: graphs.petersen(), doc="the Petersen graph (10,3)")
register_topology(
    "circulant",
    lambda s, _dev: graphs.circulant(int(_req(s, "n")),
                               [int(o) for o in _req(s, "offsets")],
                               s.kwargs.get("name")),
    parse=lambda p: {"n": int(p[0]), "offsets": [int(o) for o in p[1].split(",")]},
    doc="circulant C_N(s1..sk) — the rotationally-symmetric search family")
register_topology(
    "torus",
    lambda s, _dev: graphs.torus([int(d) for d in _req(s, "dims")]),
    parse=lambda p: {"dims": [int(d) for d in p[0].split("x")]},
    doc="k-ary n-cube torus with wraparound, e.g. 'torus:4x8'")
register_topology(
    "hypercube", lambda s, _dev: graphs.hypercube(int(_req(s, "dim"))),
    parse=lambda p: {"dim": int(p[0])}, doc="Q_dim (N = 2^dim)")
register_topology(
    "dragonfly",
    lambda s, _dev: graphs.dragonfly(int(_req(s, "a")),
                               s.kwargs.get("g"),
                               int(s.kwargs.get("h", 1))),
    parse=lambda p: dict(zip(("a", "g", "h"), (int(x) for x in p[0].split(",")))),
    doc="canonical Dragonfly(a, g, h) at router granularity (Kim et al.)")
register_topology(
    "random-regular",
    lambda s, _dev: graphs.random_regular(
        int(_req(s, "n")), int(_req(s, "k")), seed=s.seed,
        max_tries=int(s.kwargs.get("max_tries", 2000))),
    parse=lambda p: dict(zip(("n", "k"), (int(x) for x in p[0].split(",")))),
    doc="pairing-model random k-regular graph (seeded)")
register_topology(
    "random-hamiltonian-regular",
    lambda s, _dev: graphs.random_hamiltonian_regular(
        int(_req(s, "n")), int(_req(s, "k")), seed=s.seed,
        max_tries=int(s.kwargs.get("max_tries", 2000))),
    parse=lambda p: dict(zip(("n", "k"), (int(x) for x in p[0].split(",")))),
    doc="random k-regular graph containing the ring 0-1-…-N-1 (SA start)")


def _build_optimal(spec: TopologySpec, device=None) -> Graph:
    from . import specs

    kw = spec.kwargs
    n, k = int(_req(spec, "n")), int(_req(spec, "k"))
    extra = {key: v for key, v in kw.items() if key not in ("n", "k")}
    return specs.search(
        specs.SearchSpec.make(n, k, seed=spec.seed, **extra), device).graph


def _build_suboptimal(spec: TopologySpec, device=None) -> Graph:
    """Large-N suboptimal graph: circulant warm start + orbit-SA polish,
    falling back to the pure symmetric walk if the polish path degrades —
    the exact two-stage recipe ``benchmarks/common.suboptimal_sym`` pinned
    (trajectory-identical per seed).  Both stages price on ``device``; an
    ``engine`` param is validated by ``specs.check_engine`` as the
    reference's is by its engine registry."""
    from . import specs

    n, k = int(_req(spec, "n")), int(_req(spec, "k"))
    kw = spec.kwargs
    n_iter = int(kw.get("n_iter", 1500))
    fold = int(kw.get("fold", 4))
    engine = kw.get("engine")
    res = specs.search(specs.SearchSpec(
        n=n, k=k, strategy="large", budget=max(400, n_iter // 3), fold=fold,
        engine=engine, seed=spec.seed), device)
    sym = specs.search(specs.SearchSpec(
        n=n, k=k, strategy="symmetric-sa", budget=n_iter, fold=fold,
        engine=engine, seed=spec.seed), device)
    return (res if (res.mpl, res.diameter) <= (sym.mpl, sym.diameter) else sym).graph


def _parse_cluster_hub(p: list[str]) -> dict:
    cs = p[0].split("x")
    if len(cs) != 2:
        raise ValueError(
            "cluster-hub spec is 'cluster-hub:CxS[:inner[:outer]]', "
            "e.g. 'cluster-hub:4x8:complete:ring'")
    out = {"clusters": int(cs[0]), "size": int(cs[1])}
    if len(p) > 1:
        out["inner"] = p[1]
    if len(p) > 2:
        out["outer"] = p[2]
    return out


register_topology(
    "cluster-hub",
    lambda s, _dev: graphs.cluster_hub(
        int(_req(s, "clusters")), int(_req(s, "size")),
        inner=str(s.kwargs.get("inner", "complete")),
        outer=str(s.kwargs.get("outer", "ring"))),
    parse=_parse_cluster_hub,
    doc="hierarchical cluster-hub network: C clusters of S nodes, hubs on "
        "a backbone ('cluster-hub:4x8[:inner[:outer]]')")


def _build_nested(spec: TopologySpec, device=None) -> Graph:
    outer = build_topology(str(_req(spec, "outer")), device, seed=spec.seed)
    inner = build_topology(str(_req(spec, "inner")), device, seed=spec.seed)
    return graphs.nested_compose(outer, inner,
                                 hub=int(spec.kwargs.get("hub", 0)))


register_topology(
    "nested",
    _build_nested,
    parse=lambda p: {"outer": p[0].replace("/", ":"),
                     "inner": p[1].replace("/", ":")},
    doc="general nested composition: one inner copy per outer vertex, hubs "
        "linked by the outer edges; params are string specs "
        "('nested:ring/4:torus/2x4' — '/' stands in for ':' inside parts)")


register_topology(
    "optimal", _build_optimal,
    parse=lambda p: dict(zip(("n", "k"), (int(x) for x in p[0].split(",")))),
    doc="searched minimal-MPL graph: specs.search(SearchSpec(n, k, …))",
    searched=True)
register_topology(
    "suboptimal", _build_suboptimal,
    parse=lambda p: dict(zip(("n", "k"), (int(x) for x in p[0].split(",")))),
    doc="large-N two-stage suboptimal graph (circulant warm start + orbit "
        "polish vs pure symmetric walk, best of both)",
    searched=True)


# --------------------------------------------------------------------------------
# Paper benchmark suites (formerly benchmarks/common.py's suite builders)
# --------------------------------------------------------------------------------

def _T(family: str, **params) -> TopologySpec:
    return TopologySpec.make(family, **params)


PAPER_SUITES: dict[str, dict[str, TopologySpec]] = {
    "16": {
        "(16,2)-Ring": _T("ring", n=16),
        "(16,3)-Wagner": _T("wagner", n=16),
        "(16,3)-Bidiakis": _T("bidiakis", n=16),
        "(16,3)-Optimal": _T("optimal", n=16, k=3, budget=5000),
        "(16,4)-Torus": _T("torus", dims=[4, 4]),
        "(16,4)-Optimal": _T("optimal", n=16, k=4, budget=5000),
    },
    "32": {
        "(32,2)-Ring": _T("ring", n=32),
        "(32,3)-Wagner": _T("wagner", n=32),
        "(32,3)-Bidiakis": _T("bidiakis", n=32),
        "(32,3)-Optimal": _T("optimal", n=32, k=3, budget=6000),
        "(32,4)-Torus": _T("torus", dims=[4, 8]),
        "(32,4)-Chvatal": _T("chvatal32"),
        "(32,4)-Optimal": _T("optimal", n=32, k=4, budget=6000),
    },
    "256": {
        "(256,2)-Ring": _T("ring", n=256),
        "(256,3)-Wagner": _T("wagner", n=256),
        "(256,3)-Bidiakis": _T("bidiakis", n=256),
        "(256,3)-Suboptimal": _T("suboptimal", n=256, k=3),
        "(256,4)-Torus": _T("torus", dims=[16, 16]),
        "(256,4)-Suboptimal": _T("suboptimal", n=256, k=4),
        "(256,6)-Torus": _T("torus", dims=[4, 8, 8]),
        "(256,6)-Suboptimal": _T("suboptimal", n=256, k=6),
        "(256,8)-Torus": _T("torus", dims=[4, 4, 4, 4]),
        "(256,8)-Suboptimal": _T("suboptimal", n=256, k=8),
    },
    # optimal-vs-dragonfly pairs for TABLE 2/3: "<key>-Optimal" / "<key>-Dragonfly"
    "dragonfly": {
        "(20,4)-Optimal": _T("optimal", n=20, k=4, budget=5000),
        "(20,4)-Dragonfly": _T("dragonfly", a=4, g=5, h=1),
        "(30,5)-Optimal": _T("optimal", n=30, k=5, budget=5000),
        "(30,5)-Dragonfly": _T("dragonfly", a=5, g=6, h=1),
        "(36,5)-Optimal": _T("optimal", n=36, k=5, budget=5000),
        "(36,5)-Dragonfly": _T("dragonfly", a=4, g=9, h=2),
    },
    # perfect palmtree instances (g = a*h + 1 ⇒ regular) for TABLE 5/6
    "large-dragonfly": {
        "(252,11)-Optimal": _T("optimal", n=252, k=11, strategy="circulant",
                               budget=400),
        "(252,11)-Dragonfly": _T("dragonfly", a=9, g=28, h=3),
        "(264,11)-Optimal": _T("optimal", n=264, k=11, strategy="circulant",
                               budget=400),
        "(264,11)-Dragonfly": _T("dragonfly", a=8, g=33, h=4),
    },
}


def paper_suite(key: str | int) -> dict[str, TopologySpec]:
    """The paper's benchmark suites as name → :class:`TopologySpec` dicts.

    Keys: ``"16"`` / ``"32"`` (TABLE 1, Figs 2-8), ``"256"`` (TABLE 4,
    Fig 10), ``"dragonfly"`` (TABLE 2/3), ``"large-dragonfly"``
    (TABLE 5/6).  Returns a fresh dict — callers may mutate it freely.
    """
    k = str(key).replace("_", "-")
    if k not in PAPER_SUITES:
        raise ValueError(
            f"unknown paper suite {key!r}: known suites are "
            f"{', '.join(PAPER_SUITES)}")
    return dict(PAPER_SUITES[k])
