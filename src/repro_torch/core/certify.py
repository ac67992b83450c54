"""Certified best-known-graph table and the independent certification path
(the counterpart of ``repro.core.certify``, all of it, host numpy).

The table, ``data/certified.json``, is the port's own byte-equal copy of the
reference's: the pinned ``(16,4)``/``(32,3)``/``(32,4)`` optimal edge lists,
the circulant offset sets through N=16384 and the paper's named <=36-node
baseline topologies, each with its certificate

    (n, k, family, edges-hash, total-hops, MPL, diameter, bisection,
     fold/symmetry, SearchSpec provenance, engine)

``certify(graph)`` recomputes a certificate from scratch through a path of
its own: a per-source level BFS over the neighbour table (``_sssp_levels``),
not ``IncrementalAPSP``/``SymmetricAPSP``, not the word-packed sweep and not
the CUDA kernels, so a fault in any of them cannot certify its own wrong
answer.  ``verify_entry`` diffs a recorded entry against the recomputation.
``repro_torch.core.known_optimal`` loads its pinned warm starts from this
table.

One deliberate difference: an entry that carries only a ``spec`` is built
as ``graphs.REGISTRY[family](**params)``; the reference builds it through
``topologies.build_topology``, which the port does not have yet (ROADMAP
Queue 1, item 6.7).  A spec outside that reach raises
``NotImplementedError``; no entry of today's table does.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import json
import os
from collections.abc import Iterable, Mapping
from typing import Any

import numpy as np

from .graphs import REGISTRY, Graph, circulant, from_edges

__all__ = [
    "TABLE_PATH",
    "Certificate",
    "certify",
    "edges_hash",
    "load_table",
    "table_entries",
    "get_entry",
    "build_entry_graph",
    "entry_graph",
    "verify_entry",
    "make_entry",
    "warm_start_graph",
]

# data/certified.json of this package (package-data covers wheels)
TABLE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "certified.json")


# --------------------------------------------------------------------------------
# The independent certification path: per-source level BFS over the
# neighbour table.  Intentionally NOT shared with repro.core.metrics — this
# is the recomputation the incremental engines are checked against.
# --------------------------------------------------------------------------------

def _neighbour_table(g: Graph) -> np.ndarray:
    """Padded (n, max_degree) int64 neighbour table, -1 padded."""
    lists = g.adjacency_lists()
    kmax = max((len(nb) for nb in lists), default=0)
    nbr = np.full((g.n, max(kmax, 1)), -1, dtype=np.int64)
    for u, nb in enumerate(lists):
        nbr[u, : len(nb)] = nb
    return nbr


def _sssp_levels(nbr: np.ndarray, n: int, src: int) -> np.ndarray:
    """Hop distances from ``src`` (-1 for unreachable) by level expansion.

    Each level gathers the frontier's neighbour rows in one vectorised
    fancy-index — no matmul, no bit packing, no distance-delta rules — so
    the result depends only on the neighbour table and elementary set
    logic.  O(D) numpy calls per source, O(m) work per level total.
    """
    dist = np.full(n, -1, dtype=np.int64)
    dist[src] = 0
    frontier = np.asarray([src], dtype=np.int64)
    d = 0
    while frontier.size:
        d += 1
        cand = nbr[frontier].ravel()
        cand = cand[cand >= 0]
        cand = np.unique(cand[dist[cand] < 0])
        if not cand.size:
            break
        dist[cand] = d
        frontier = cand
    return dist


@dataclasses.dataclass(frozen=True)
class Certificate:
    """A from-scratch recomputation of a graph's pinned invariants."""

    n: int
    k: int
    edges_hash: str
    total_hops: int  # sum of hop distances over ordered distinct pairs
    mpl: float
    diameter: int
    connected: bool
    bisection: int | None = None  # only computed on request (heuristic > n=20)

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def edges_hash(g: Graph) -> str:
    """sha256 of the canonical sorted edge list — the graph's identity."""
    payload = ";".join(f"{u},{v}" for u, v in sorted(g.edges))
    return "sha256:" + hashlib.sha256(
        f"{g.n}|{payload}".encode()).hexdigest()[:32]


def certify(g: Graph, bisection: bool = False,
            bw_restarts: int = 24, seed: int = 0) -> Certificate:
    """Recompute a graph's certificate from scratch (independent BFS).

    ``bisection=True`` additionally recomputes the bisection width
    (``metrics.bisection_width`` — exact for n <= 20, deterministic
    KL-heuristic upper bound per (restarts, seed) above).  MPL, diameter
    and the integer ``total_hops`` anchor come from :func:`_sssp_levels`,
    a code path the search engines never touch.
    """
    n = g.n
    nbr = _neighbour_table(g)
    total = 0
    diam = 0
    connected = True
    for src in range(n):
        dist = _sssp_levels(nbr, n, src)
        if (dist < 0).any():
            connected = False
            break
        total += int(dist.sum())
        diam = max(diam, int(dist.max()))
    if not connected:
        mpl_v: float = float("inf")
        total, diam = -1, -1
    else:
        mpl_v = total / (n * (n - 1)) if n > 1 else 0.0
    bw: int | None = None
    if bisection and connected:
        from . import metrics  # lazy: keep table loading free of torch

        bw = int(metrics.bisection_width(g, restarts=bw_restarts, seed=seed))
    k = int(g.degrees().max()) if n else 0
    return Certificate(n=n, k=k, edges_hash=edges_hash(g), total_hops=total,
                       mpl=mpl_v, diameter=diam, connected=connected,
                       bisection=bw)


# --------------------------------------------------------------------------------
# Table access
# --------------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _load(path: str) -> dict[str, Any]:
    with open(path) as f:
        d = json.load(f)
    if "entries" not in d or not isinstance(d["entries"], list):
        raise ValueError(f"certified table {path!r} has no 'entries' list")
    return d


def load_table(path: str | None = None) -> dict[str, Any]:
    """The certified table as a dict (cached per path)."""
    return _load(path or TABLE_PATH)


def table_entries(path: str | None = None) -> list[dict[str, Any]]:
    """All table entries, in file order."""
    return list(load_table(path)["entries"])


def get_entry(n: int, k: int, path: str | None = None) -> dict[str, Any] | None:
    """The best certified entry for ``(n, k)``: lowest (MPL, diameter).

    Only entries eligible as search warm starts are considered — the
    searched winners (``optimal`` edge lists and ``circulant`` offset
    sets), not the paper's baseline topologies (a torus is a *benchmark
    subject*, not a best-known graph).
    """
    best: dict[str, Any] | None = None
    for e in table_entries(path):
        if e["n"] != n or e["k"] != k:
            continue
        # the table's own schema vocabulary, not a registry dispatch
        if e["family"] not in ("optimal", "circulant"):
            continue
        key = (e["mpl"], e["diameter"])
        if best is None or key < (best["mpl"], best["diameter"]):
            best = e
    return best


def build_entry_graph(entry: Mapping[str, Any]) -> Graph:
    """Build the graph an entry describes (edges, offsets, or spec)."""
    name = str(entry.get("name", "certified"))
    if entry.get("edges") is not None:
        return from_edges(int(entry["n"]),
                          [tuple(e) for e in entry["edges"]], name)
    if entry.get("offsets") is not None:
        return circulant(int(entry["n"]), [int(o) for o in entry["offsets"]],
                         name)
    if entry.get("spec") is not None:
        return _build_spec(dict(entry["spec"])).with_name(name)
    raise ValueError(
        f"certified entry {name!r} has no build info (edges/offsets/spec)")


# constructors that draw from a seed: their specs need the reference's
# TopologySpec seed handling
_SEEDED = ("random_regular", "random_hamiltonian_regular")


def _build_spec(spec: dict[str, Any]) -> Graph:
    """A spec entry's graph from the constructor registry: ``family`` names a
    constructor of ``graphs.REGISTRY`` and ``params`` are its keyword
    arguments.  Anything else needs ``topologies.build_topology``, which the
    port does not have yet, and raises ``NotImplementedError``."""
    family, params = spec.get("family"), dict(spec.get("params") or {})
    fn = REGISTRY.get(family)
    if fn is None or family in _SEEDED:
        raise NotImplementedError(
            f"certified spec family {family!r} needs topologies.build_topology, "
            f"not ported yet (ROADMAP Queue 1, item 6.7)")
    try:
        inspect.signature(fn).bind(**params)
    except TypeError:
        raise NotImplementedError(
            f"certified spec {spec!r} does not match graphs.{fn.__name__}'s "
            f"arguments; it needs topologies.build_topology, not ported yet "
            f"(ROADMAP Queue 1, item 6.7)") from None
    return fn(**params)


# legacy-friendly alias used by docs/examples
entry_graph = build_entry_graph


def verify_entry(entry: Mapping[str, Any], full: bool = True) -> list[str]:
    """Diff a recorded entry against a from-scratch recomputation.

    Returns a list of human-readable discrepancy strings (empty = certified
    values confirmed).  ``full=False`` only rebuilds the graph and checks
    the edges-hash (cheap at any N); ``full=True`` recomputes total hops /
    MPL / diameter via the independent BFS and — when the entry records
    one — the bisection width with the recorded restart budget.
    """
    name = str(entry.get("name", "?"))
    errors: list[str] = []
    try:
        g = build_entry_graph(entry)
    except Exception as exc:  # noqa: BLE001 - report, don't crash the gate
        return [f"entry {name!r}: graph rebuild failed: {exc}"]
    if g.n != entry["n"]:
        errors.append(f"entry {name!r}: n recorded {entry['n']} != built {g.n}")
    got_hash = edges_hash(g)
    if got_hash != entry["edges_hash"]:
        errors.append(
            f"entry {name!r}: edges_hash recorded {entry['edges_hash']} != "
            f"recomputed {got_hash}")
    if not full:
        return errors
    cert = certify(g, bisection=entry.get("bisection") is not None)
    for field in ("k", "total_hops", "diameter"):
        if entry.get(field) is not None and entry[field] != getattr(cert, field):
            errors.append(
                f"entry {name!r}: {field} recorded {entry[field]} != "
                f"recomputed {getattr(cert, field)}")
    if abs(cert.mpl - float(entry["mpl"])) > 1e-9:
        errors.append(
            f"entry {name!r}: mpl recorded {entry['mpl']} != "
            f"recomputed {cert.mpl!r}")
    if entry.get("bisection") is not None and cert.bisection != entry["bisection"]:
        errors.append(
            f"entry {name!r}: bisection recorded {entry['bisection']} != "
            f"recomputed {cert.bisection}")
    return errors


def make_entry(
    g: Graph,
    family: str,
    *,
    name: str | None = None,
    offsets: Iterable[int] | None = None,
    spec: Mapping[str, Any] | None = None,
    store_edges: bool = False,
    bisection: bool = False,
    fold: int | None = None,
    provenance: Mapping[str, Any] | None = None,
    engine: str | None = None,
) -> dict[str, Any]:
    """Certify ``g`` and package the result as a table entry dict.

    This is how new search winners are recorded: certify the graph through
    the independent path, attach the replayable ``SearchSpec`` provenance
    and the engine that found it, and append the dict to
    ``certified.json``'s ``entries``.
    """
    cert = certify(g, bisection=bisection)
    entry: dict[str, Any] = {
        "name": name or g.name,
        "n": g.n,
        "k": cert.k,
        "family": family,
        "edges_hash": cert.edges_hash,
        "total_hops": cert.total_hops,
        "mpl": cert.mpl,
        "diameter": cert.diameter,
        "bisection": cert.bisection,
        "fold": fold,
        "provenance": dict(provenance) if provenance is not None else None,
        "engine": engine,
    }
    if offsets is not None:
        entry["offsets"] = [int(o) for o in offsets]
    if store_edges:
        entry["edges"] = [list(e) for e in g.edges]
    if spec is not None:
        entry["spec"] = dict(spec)
    return entry


def warm_start_graph(n: int, k: int, path: str | None = None) -> Graph | None:
    """Best certified ``(n, k)`` graph, rebuilt — the SA warm start.

    Returns None when no searched entry matches (constructive baseline
    entries never warm-start a search).
    """
    entry = get_entry(n, k, path)
    if entry is None:
        return None
    return build_entry_graph(entry).with_name(f"({n},{k})-Certified")
