"""Per-topology collective-schedule synthesis (the co-design half; the
counterpart of ``repro.comm.schedules``, a numpy copy held equal by the
tests).

``core.collectives`` prices the *legacy* MPICH-style rank algorithms — trees
and rings laid out in rank space, so a single logical transfer may cross many
physical hops and congest shared links.  This module closes the loop the
ROADMAP's co-design item names (after "Efficient Direct-Connect Topologies
for Collective Communications", arXiv 2202.03356): given any ``Graph`` —
searched or mainstream — it *synthesizes* a schedule from the graph's own
structure and prices it with the same link-load-aware simulator, so topology
search can minimise synthesized-schedule time directly
(``SearchSpec(objective="collective-time")``).

Synthesized forms:

- **bcast / reduce / scatter / gather** — a BFS-expansion spanning tree
  rooted at ``root`` (deterministic lowest-index BFS, every transfer a real
  graph edge, so every round is 1-hop and link-disjoint).  Reduce/gather are
  the exact mirror of the bcast/scatter rounds.
- **allreduce** — chosen from the graph's structure by pricing every
  applicable candidate on the routed cluster and keeping the cheapest
  (deterministic tie-break by candidate order):

  * ``ring`` — reduce-scatter + allgather along a Hamiltonian cycle
    (``core.hamiltonian``), so every step is a 1-hop neighbour exchange;
  * ``halving-doubling`` — recursive-halving reduce-scatter + recursive-
    doubling allgather (power-of-two n), log-round latency at the price of
    multi-hop XOR-partner exchanges;
  * ``tree`` — BFS-tree reduce to the root followed by the tree broadcast,
    the fallback that only needs connectivity.

The cost model is ``core.collectives.simulate`` — per-round latency plus
per-link serialization from the actual routed link loads of
``core.routing.RoutingTable`` — never a hop-count heuristic.  Every schedule
also *executes* numerically (:func:`execute_allreduce`), which is how the
tests pin bitwise-correct reductions against a naive reference.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core import collectives as C
from ..core.graphs import Graph
from ..core.hamiltonian import hamiltonian_cycle
from ..core.routing import RoutingTable

__all__ = [
    "SpanningTree",
    "SynthesizedCollective",
    "SYNTH_OPS",
    "bfs_tree",
    "tree_bcast",
    "tree_reduce",
    "tree_scatter",
    "tree_gather",
    "ring_allreduce",
    "halving_doubling_allreduce",
    "tree_allreduce",
    "allreduce_candidates",
    "synthesize",
    "synthesized_time",
    "execute_allreduce",
]

#: ops this module synthesizes; anything else (alltoall, allgather, ...)
#: stays on the legacy ``core.collectives`` rank algorithms.
SYNTH_OPS = frozenset({"bcast", "reduce", "scatter", "gather", "allreduce"})

#: candidate order = deterministic tie-break order for allreduce selection
ALLREDUCE_CANDIDATES = ("ring", "halving-doubling", "tree")


# ------------------------------------------------------------------------------
# BFS-expansion spanning tree
# ------------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpanningTree:
    """A rooted BFS spanning tree: ``parent[root] == -1``, ``order`` is the
    BFS visit order (root first), ``depth[v]`` the tree distance to root."""

    root: int
    parent: tuple[int, ...]
    depth: tuple[int, ...]
    order: tuple[int, ...]

    @property
    def height(self) -> int:
        return max(self.depth)

    def children(self) -> list[list[int]]:
        out: list[list[int]] = [[] for _ in self.parent]
        for v in self.order:
            if v != self.root:
                out[self.parent[v]].append(v)
        return out

    def subtree_sizes(self) -> list[int]:
        size = [1] * len(self.parent)
        for v in reversed(self.order):
            if v != self.root:
                size[self.parent[v]] += size[v]
        return size


def bfs_tree(g: Graph, root: int = 0) -> SpanningTree:
    """Deterministic BFS spanning tree: frontier scanned in index order,
    neighbours attached lowest-index-parent first."""
    n = g.n
    if not 0 <= root < n:
        raise ValueError(f"root {root} out of range for n={n}")
    adj = g.adjacency_lists()
    parent = [-1] * n
    depth = [-1] * n
    depth[root] = 0
    order = [root]
    frontier = [root]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if depth[v] < 0:
                    depth[v] = depth[u] + 1
                    parent[v] = u
                    nxt.append(v)
                    order.append(v)
        frontier = nxt
    if len(order) != n:
        raise ValueError(f"{g.name}: graph disconnected, no spanning tree")
    return SpanningTree(root=root, parent=tuple(parent), depth=tuple(depth),
                        order=tuple(order))


def tree_bcast(g: Graph, nbytes: float, root: int = 0,
               tree: SpanningTree | None = None) -> C.Schedule:
    """BFS-expansion broadcast: round d informs depth-(d+1) vertices from
    their tree parents.  Every transfer is a graph edge (1 hop) and every
    directed link carries at most one transfer per round."""
    tree = tree or bfs_tree(g, root)
    rounds: list[list[C.Transfer]] = [[] for _ in range(tree.height)]
    for v in tree.order:
        if v != tree.root:
            rounds[tree.depth[v] - 1].append(C.Transfer(tree.parent[v], v, nbytes))
    return C.Schedule(f"bcast-tree[{g.n}]r{root}", g.n, rounds)


def tree_reduce(g: Graph, nbytes: float, root: int = 0,
                tree: SpanningTree | None = None) -> C.Schedule:
    """Tree reduce: the exact mirror of :func:`tree_bcast` — partial sums
    flow child→parent, deepest round first."""
    b = tree_bcast(g, nbytes, root, tree)
    rounds = [[C.Transfer(t.dst, t.src, t.nbytes) for t in rnd]
              for rnd in reversed(b.rounds)]
    return C.Schedule(f"reduce-tree[{g.n}]r{root}", g.n, rounds)


def tree_scatter(g: Graph, nbytes: float, root: int = 0,
                 tree: SpanningTree | None = None) -> C.Schedule:
    """Tree scatter: each parent forwards every child its whole subtree's
    chunks in one message (``nbytes`` = per-destination chunk, the paper's
    unit message size)."""
    tree = tree or bfs_tree(g, root)
    size = tree.subtree_sizes()
    rounds: list[list[C.Transfer]] = [[] for _ in range(tree.height)]
    for v in tree.order:
        if v != tree.root:
            rounds[tree.depth[v] - 1].append(
                C.Transfer(tree.parent[v], v, size[v] * nbytes))
    return C.Schedule(f"scatter-tree[{g.n}]r{root}", g.n, rounds)


def tree_gather(g: Graph, nbytes: float, root: int = 0,
                tree: SpanningTree | None = None) -> C.Schedule:
    sc = tree_scatter(g, nbytes, root, tree)
    rounds = [[C.Transfer(t.dst, t.src, t.nbytes) for t in rnd]
              for rnd in reversed(sc.rounds)]
    return C.Schedule(f"gather-tree[{g.n}]r{root}", g.n, rounds)


# ------------------------------------------------------------------------------
# Allreduce candidates
# ------------------------------------------------------------------------------

def ring_allreduce(g: Graph, nbytes: float,
                   order: Sequence[int]) -> C.Schedule:
    """Ring reduce-scatter + allgather along a Hamiltonian cycle ``order`` of
    the physical graph — every step a 1-hop neighbour exchange."""
    n = g.n
    if sorted(order) != list(range(n)):
        raise ValueError("order must be a permutation of range(n)")
    chunk = nbytes / n
    step = [C.Transfer(order[i], order[(i + 1) % n], chunk) for i in range(n)]
    rounds = [list(step) for _ in range(2 * (n - 1))]
    return C.Schedule(f"allreduce-ring-ham[{n}]", n, rounds)


def halving_doubling_allreduce(n: int, nbytes: float) -> C.Schedule:
    """Recursive-halving reduce-scatter + recursive-doubling allgather.

    Step j of the halving phase exchanges ``nbytes / 2**(j+1)`` with the
    partner at XOR distance ``n >> (j+1)``; the doubling phase mirrors the
    masks back up.  Power-of-two ``n`` only.
    """
    if n < 2 or n & (n - 1):
        raise ValueError("halving-doubling needs power-of-two n >= 2")
    rounds = []
    masks = []
    m, sz = n >> 1, nbytes / 2.0
    while m >= 1:
        masks.append((m, sz))
        m >>= 1
        sz /= 2.0
    for m, sz in masks:  # reduce-scatter (halving)
        rounds.append([C.Transfer(i, i ^ m, sz) for i in range(n)])
    for m, sz in reversed(masks):  # allgather (doubling)
        rounds.append([C.Transfer(i, i ^ m, sz) for i in range(n)])
    return C.Schedule(f"allreduce-halvdbl[{n}]", n, rounds)


def tree_allreduce(g: Graph, nbytes: float, root: int = 0,
                   tree: SpanningTree | None = None) -> C.Schedule:
    """Fallback allreduce: tree reduce to ``root`` then tree broadcast."""
    tree = tree or bfs_tree(g, root)
    red = tree_reduce(g, nbytes, root, tree)
    bc = tree_bcast(g, nbytes, root, tree)
    return C.Schedule(f"allreduce-tree[{g.n}]r{root}", g.n,
                      red.rounds + bc.rounds)


def allreduce_candidates(
    g: Graph,
    nbytes: float,
    *,
    root: int = 0,
    cycle_budget: int = 100_000,
) -> dict[str, tuple[C.Schedule, dict]]:
    """The structurally applicable allreduce schedules for ``g``.

    Returns ``{name: (schedule, meta)}`` in :data:`ALLREDUCE_CANDIDATES`
    order; ``meta`` carries the structure the schedule was derived from
    (cycle order / spanning tree).  ``cycle_budget`` bounds the Hamiltonian
    DFS for foreign graphs (searched graphs embed the ring, O(n) check).
    """
    out: dict[str, tuple[C.Schedule, dict]] = {}
    cycle = hamiltonian_cycle(g, budget=cycle_budget) if g.n >= 3 else None
    if cycle is not None:
        out["ring"] = (ring_allreduce(g, nbytes, cycle),
                       {"order": tuple(cycle)})
    if g.n >= 2 and not (g.n & (g.n - 1)):
        out["halving-doubling"] = (halving_doubling_allreduce(g.n, nbytes), {})
    tree = bfs_tree(g, root)
    out["tree"] = (tree_allreduce(g, nbytes, root, tree), {"tree": tree})
    return out


# ------------------------------------------------------------------------------
# Synthesis + pricing
# ------------------------------------------------------------------------------

@dataclasses.dataclass
class SynthesizedCollective:
    """One synthesized schedule with its priced report and the per-candidate
    times the choice was made from (empty for single-candidate ops)."""

    op: str
    algorithm: str
    schedule: C.Schedule
    report: C.CollectiveReport
    candidates: dict[str, float]
    order: tuple[int, ...] | None = None
    tree: SpanningTree | None = None

    @property
    def time(self) -> float:
        return self.report.time


def synthesize(
    g: Graph,
    op: str,
    nbytes: float,
    *,
    model: C.LinkModel = C.TAISHAN_LINK,
    rt: RoutingTable | None = None,
    root: int = 0,
    cycle_budget: int = 100_000,
) -> SynthesizedCollective:
    """Synthesize + price collective ``op`` for graph ``g``.

    Rooted ops build the BFS spanning tree at ``root``; allreduce prices
    every applicable candidate (ring / halving-doubling / tree) on the
    routed cluster and keeps the cheapest (ties break in candidate order,
    so the choice is deterministic).
    """
    if op not in SYNTH_OPS:
        raise ValueError(
            f"op={op!r} has no synthesized form: choose from "
            f"{', '.join(sorted(SYNTH_OPS))} (legacy rank algorithms in "
            "core.collectives cover the rest)")
    rt = rt or RoutingTable.build(g)
    if op == "allreduce":
        cands = allreduce_candidates(g, nbytes, root=root,
                                     cycle_budget=cycle_budget)
        priced = {name: C.simulate(sched, rt, model)
                  for name, (sched, _) in cands.items()}
        best = min(priced, key=lambda name: (priced[name].time,
                                             ALLREDUCE_CANDIDATES.index(name)))
        sched, meta = cands[best]
        return SynthesizedCollective(
            op=op, algorithm=best, schedule=sched, report=priced[best],
            candidates={name: rep.time for name, rep in priced.items()},
            order=meta.get("order"), tree=meta.get("tree"))
    tree = bfs_tree(g, root)
    builder = {"bcast": tree_bcast, "reduce": tree_reduce,
               "scatter": tree_scatter, "gather": tree_gather}[op]
    sched = builder(g, nbytes, root, tree)
    return SynthesizedCollective(
        op=op, algorithm="tree", schedule=sched,
        report=C.simulate(sched, rt, model), candidates={}, tree=tree)


def synthesized_time(
    g: Graph,
    op: str,
    nbytes: float,
    *,
    model: C.LinkModel = C.TAISHAN_LINK,
    rt: RoutingTable | None = None,
    root: int | None = None,
    cycle_budget: int = 100_000,
) -> C.CollectiveReport:
    """Priced report of the synthesized schedule, mirroring the legacy
    ``core.collectives.collective_time`` conventions: rooted ops with
    ``root=None`` average over every root (the paper's averaging)."""
    rt = rt or RoutingTable.build(g)
    rooted = op in ("bcast", "reduce", "scatter", "gather")
    if rooted and root is None:
        reps = [synthesize(g, op, nbytes, model=model, rt=rt, root=r,
                           cycle_budget=cycle_budget).report
                for r in range(g.n)]
        base = reps[0]
        return C.CollectiveReport(
            schedule=base.schedule + "-rootavg",
            topology=base.topology,
            time=float(np.mean([r.time for r in reps])),
            latency_time=float(np.mean([r.latency_time for r in reps])),
            serial_time=float(np.mean([r.serial_time for r in reps])),
            rounds=base.rounds,
            max_link_bytes=float(np.max([r.max_link_bytes for r in reps])),
            total_link_bytes=float(np.mean([r.total_link_bytes for r in reps])),
        )
    return synthesize(g, op, nbytes, model=model, rt=rt, root=root or 0,
                      cycle_budget=cycle_budget).report


# ------------------------------------------------------------------------------
# Numeric execution — correctness, not cost
# ------------------------------------------------------------------------------

def execute_allreduce(synth: SynthesizedCollective,
                      values: np.ndarray) -> np.ndarray:
    """Execute a synthesized allreduce on per-node data ``values[n, m]``.

    Returns the (n, m) array every node ends up holding (1-D input, one
    scalar per node, comes back 1-D).  Data movement follows the
    synthesized algorithm exactly; with integer-valued inputs the result
    is bitwise-equal to ``values.sum(axis=0)`` at every node (asserted by
    tests/test_schedules.py).
    """
    values = np.asarray(values)
    scalar = values.ndim == 1
    if scalar:
        values = values[:, None]
    if synth.op != "allreduce":
        raise ValueError(f"not an allreduce synthesis: {synth.op!r}")
    if synth.algorithm == "ring":
        out = _exec_ring(values, synth.order)
    elif synth.algorithm == "halving-doubling":
        out = _exec_halving_doubling(values)
    elif synth.algorithm == "tree":
        out = _exec_tree(values, synth.tree)
    else:
        raise ValueError(f"unknown algorithm {synth.algorithm!r}")  # pragma: no cover
    return out[:, 0] if scalar else out


def _chunks(m: int, n: int) -> list[slice]:
    bounds = [round(i * m / n) for i in range(n + 1)]
    return [slice(bounds[i], bounds[i + 1]) for i in range(n)]


def _exec_ring(values: np.ndarray, order: Sequence[int]) -> np.ndarray:
    n = values.shape[0]
    sl = _chunks(values.shape[1], n)
    buf = values.astype(values.dtype, copy=True)
    # reduce-scatter: position i sends chunk (i - s) % n to position i + 1
    for s in range(n - 1):
        sent = [buf[order[i], sl[(i - s) % n]].copy() for i in range(n)]
        for i in range(n):
            buf[order[(i + 1) % n], sl[(i - s) % n]] += sent[i]
    # position i now owns the fully reduced chunk (i + 1) % n
    # allgather: forward the most recently completed chunk around the ring
    for s in range(n - 1):
        sent = [buf[order[i], sl[(i + 1 - s) % n]].copy() for i in range(n)]
        for i in range(n):
            buf[order[(i + 1) % n], sl[(i + 1 - s) % n]] = sent[i]
    return buf


def _exec_halving_doubling(values: np.ndarray) -> np.ndarray:
    n = values.shape[0]
    sl = _chunks(values.shape[1], n)
    buf = values.astype(values.dtype, copy=True)
    # each rank's owned segment range [lo, hi) over the n chunks
    lo = [0] * n
    hi = [n] * n
    m = n >> 1
    while m >= 1:  # recursive halving: keep the half matching your own bit
        sent = []
        for i in range(n):
            mid = (lo[i] + hi[i]) >> 1
            keep = (lo[i], mid) if not i & m else (mid, hi[i])
            give = (mid, hi[i]) if not i & m else (lo[i], mid)
            seg = np.concatenate([buf[i, sl[c]] for c in range(*give)], axis=0) \
                if give[0] < give[1] else None
            sent.append((give, seg, keep))
        for i in range(n):
            give, seg, keep = sent[i ^ m]
            lo[i], hi[i] = sent[i][2]
            if seg is not None:
                off = 0
                for c in range(*give):
                    w = sl[c].stop - sl[c].start
                    buf[i, sl[c]] += seg[off:off + w]
                    off += w
        m >>= 1
    m = 1
    while m < n:  # recursive doubling: mirror the owned ranges back
        sent = [(lo[i], hi[i],
                 np.concatenate([buf[i, sl[c]] for c in range(lo[i], hi[i])],
                                axis=0)) for i in range(n)]
        for i in range(n):
            plo, phi, seg = sent[i ^ m]
            off = 0
            for c in range(plo, phi):
                w = sl[c].stop - sl[c].start
                buf[i, sl[c]] = seg[off:off + w]
                off += w
            lo[i], hi[i] = min(lo[i], plo), max(hi[i], phi)
        m <<= 1
    return buf


def _exec_tree(values: np.ndarray, tree: SpanningTree) -> np.ndarray:
    buf = values.astype(values.dtype, copy=True)
    for v in reversed(tree.order):  # reduce: children accumulate upward
        if v != tree.root:
            buf[tree.parent[v]] += buf[v]
    total = buf[tree.root]
    out = np.broadcast_to(total, values.shape).astype(values.dtype, copy=True)
    return out
