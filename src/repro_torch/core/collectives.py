"""Collective-communication schedules over an arbitrary interconnect graph
(the counterpart of ``repro.core.collectives``, a numpy copy held equal by
the tests).

The paper benchmarks MPI collectives (Bcast / Reduce / Scatter / Alltoall) on
clusters whose network topology is a regular graph with static shortest-path
routing.  MPI treats its internal algorithms as a black box; here they are
explicit: every collective is compiled to a ``Schedule`` — a list of rounds of
point-to-point ``Transfer``s between *ranks* — and the schedule is then costed
on a concrete ``Graph`` + ``RoutingTable`` with an α–β link model and per-link
contention.  This is exactly the mechanism by which topology (MPL, diameter,
bisection) enters collective performance in the paper.  Executing the same
schedules on devices (the reference's ``comm.jaxcoll``) is not ported yet
(ROADMAP Queue 1, item 7).

Cost model (paper §4.2 + SimGrid setup of §4.4.2):
    round_time = max over transfers  (T0 + α·hops(src,dst))        [latency]
               + max over directed links (bytes crossing / link_bw) [serialization]
    total = Σ round_time.

The serialization term is where static-routing congestion bites the torus on
all-to-all (paper's repeated observation); the latency term is where MPL/D
bite everything else.

The rank-space algorithms below (binomial trees, rank-ring allreduce,
pairwise alltoall) are **the documented legacy cost model**: they schedule in
rank space and ignore the physical graph except through routing, exactly like
the hop-count heuristics the paper's fig-4 used.  Topology-aware schedules —
synthesized per graph from its actual structure — live in
``repro_torch.comm.schedules`` and are benchmarked *against* this model; every
caller that used to hand-roll algorithm selection (e.g. the power-of-two
allreduce pick that was split between netsim and the fig-4 benchmark) now
goes through :func:`default_allreduce`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Sequence

import numpy as np

from .graphs import Graph
from .routing import (AdaptiveConfig, DEFAULT_ADAPTIVE, RoutingTable,
                      adaptive_link_loads)

__all__ = [
    "LinkModel",
    "TAISHAN_LINK",
    "TPU_ICI_LINK",
    "Transfer",
    "Schedule",
    "CollectiveReport",
    "simulate",
    "bcast_binomial",
    "bcast_flood",
    "reduce_binomial",
    "scatter_binomial",
    "gather_binomial",
    "allgather_ring",
    "reduce_scatter_ring",
    "allreduce_ring",
    "allreduce_recursive_doubling",
    "alltoall_pairwise",
    "alltoall_direct",
    "ALGORITHMS",
    "default_allreduce",
    "collective_time",
]


# ------------------------------------------------------------------------------
# Link model
# ------------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinkModel:
    """α–β model of one network link.

    t0     per-message initiation time, seconds (the paper's T0)
    alpha  per-hop forwarding latency, seconds (the paper's α slope)
    bw     per-link bandwidth, bytes/second
    """

    t0: float
    alpha: float
    bw: float
    name: str = "link"

    def p2p_time(self, hops: float, nbytes: float) -> float:
        """Uncontended point-to-point time for one message."""
        if hops <= 0:
            return 0.0
        return self.t0 + self.alpha * hops + nbytes / self.bw


# The paper's own fit on Taishan: T = 107.17 + 121.15 h  (µs, 1 KB messages)
# over GigE (≈118 MB/s effective).  Used for paper-fidelity benchmarks.
TAISHAN_LINK = LinkModel(t0=107.17e-6, alpha=121.15e-6, bw=118e6, name="taishan-gige")

# The reference's second link model (~50 GB/s per link, ~1 µs per hop),
# kept so the registry of link models matches.
TPU_ICI_LINK = LinkModel(t0=1e-6, alpha=1e-6, bw=50e9, name="tpu-v5e-ici")


# ------------------------------------------------------------------------------
# Schedules
# ------------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Transfer:
    src: int
    dst: int
    nbytes: float


@dataclasses.dataclass
class Schedule:
    """Rounds of concurrent point-to-point transfers between ranks."""

    name: str
    n: int
    rounds: list[list[Transfer]]

    def total_bytes(self) -> float:
        return sum(t.nbytes for r in self.rounds for t in r)

    def validate(self) -> None:
        for r in self.rounds:
            for t in r:
                if not (0 <= t.src < self.n and 0 <= t.dst < self.n):
                    raise ValueError(f"{self.name}: transfer {t} out of range n={self.n}")
                if t.src == t.dst:
                    raise ValueError(f"{self.name}: self transfer {t}")


@dataclasses.dataclass
class CollectiveReport:
    schedule: str
    topology: str
    time: float
    latency_time: float
    serial_time: float
    rounds: int
    max_link_bytes: float
    total_link_bytes: float  # Σ bytes × hops — the "wire work"

    def __repr__(self):  # pragma: no cover
        return (
            f"<{self.schedule} on {self.topology}: {self.time*1e6:.1f}us "
            f"(lat {self.latency_time*1e6:.1f} + ser {self.serial_time*1e6:.1f}), "
            f"{self.rounds} rounds, max-link {self.max_link_bytes:.0f}B>"
        )


def simulate(schedule: Schedule, rt: RoutingTable, model: LinkModel,
             routing: str = "static",
             adaptive: AdaptiveConfig | None = None) -> CollectiveReport:
    """Cost a schedule on a routed topology with the α–β + contention model.

    ``routing`` picks the routing tier the serialization term is computed
    under: ``"static"`` walks each transfer over its one fixed Floyd path
    (the paper's model, byte-identical to the historical behaviour);
    ``"adaptive"`` splits each transfer across its minimal next-hop
    candidates weighted by the EWMA congestion score of
    :func:`repro_torch.core.routing.adaptive_link_loads`, with the occupancy
    state carried across the schedule's rounds.  The latency term is
    identical in both tiers (adaptive routes only over minimal paths).
    ``adaptive`` overrides the default :class:`AdaptiveConfig`; a zero
    ``gamma`` (congestion sensitivity off) is the static tier by
    definition, so that case short-circuits to the static branch exactly.
    """
    if routing not in ("static", "adaptive"):
        raise ValueError(f"routing={routing!r} must be 'static' or 'adaptive'")
    cfg = adaptive if adaptive is not None else DEFAULT_ADAPTIVE
    if routing == "adaptive" and cfg.gamma == 0.0:
        routing = "static"
    schedule.validate()
    lat_total = 0.0
    ser_total = 0.0
    max_link = 0.0
    wire = 0.0
    ewma_state = None
    for rnd in schedule.rounds:
        if not rnd:
            continue
        lat = 0.0
        if routing == "adaptive":
            for t in rnd:
                h = rt.dist[t.src, t.dst]
                if not np.isfinite(h):
                    raise ValueError(f"no route {t.src}->{t.dst}")
                lat = max(lat, model.t0 + model.alpha * float(h))
            loads_arr, ewma_state = adaptive_link_loads(
                rt, [(t.src, t.dst, t.nbytes) for t in rnd], cfg, ewma_state)
            peak = float(loads_arr.max()) if loads_arr.size else 0.0
            wire += float(loads_arr.sum())
            ser = peak / model.bw
            max_link = max(max_link, peak)
        else:
            loads: dict[tuple[int, int], float] = {}
            for t in rnd:
                h = rt.dist[t.src, t.dst]
                if not np.isfinite(h):
                    raise ValueError(f"no route {t.src}->{t.dst}")
                lat = max(lat, model.t0 + model.alpha * float(h))
                for link in rt.path_links(t.src, t.dst):
                    loads[link] = loads.get(link, 0.0) + t.nbytes
                    wire += t.nbytes
            ser = max(loads.values()) / model.bw if loads else 0.0
            max_link = max(max_link, max(loads.values()) if loads else 0.0)
        lat_total += lat
        ser_total += ser
    return CollectiveReport(
        schedule=schedule.name,
        topology=rt.graph.name,
        time=lat_total + ser_total,
        latency_time=lat_total,
        serial_time=ser_total,
        rounds=len(schedule.rounds),
        max_link_bytes=max_link,
        total_link_bytes=wire,
    )


# ------------------------------------------------------------------------------
# MPI-style rank algorithms (MPICH defaults, made explicit)
# ------------------------------------------------------------------------------

def _vrank(r: int, root: int, n: int) -> int:
    return (r - root) % n


def _rank(v: int, root: int, n: int) -> int:
    return (v + root) % n


def bcast_binomial(n: int, nbytes: float, root: int = 0) -> Schedule:
    """Binomial-tree broadcast (MPICH default for short/medium messages)."""
    rounds: list[list[Transfer]] = []
    mask = 1
    informed = {0}
    while mask < n:
        rnd = []
        for v in sorted(informed):
            peer = v | mask
            if peer < n and peer not in informed:
                rnd.append(Transfer(_rank(v, root, n), _rank(peer, root, n), nbytes))
        for t in rnd:
            informed.add(_vrank(t.dst, root, n))
        rounds.append(rnd)
        mask <<= 1
    return Schedule(f"bcast-binomial[{n}]", n, rounds)


def bcast_flood(n: int, nbytes: float, g: Graph, root: int = 0) -> Schedule:
    """Topology-aware broadcast: BFS flooding along actual graph edges.

    Every round, each informed node forwards to all uninformed neighbours —
    finishes in eccentricity(root) rounds with only 1-hop transfers.  This is
    the beyond-paper schedule for a known topology.
    """
    adj = g.adjacency_lists()
    informed = {root}
    rounds = []
    while len(informed) < n:
        rnd = []
        newly = set()
        for u in sorted(informed):
            for v in adj[u]:
                if v not in informed and v not in newly:
                    rnd.append(Transfer(u, v, nbytes))
                    newly.add(v)
        if not rnd:
            raise ValueError("graph disconnected")
        informed |= newly
        rounds.append(rnd)
    return Schedule(f"bcast-flood[{n}]", n, rounds)


def reduce_binomial(n: int, nbytes: float, root: int = 0) -> Schedule:
    """Binomial-tree reduce: exact mirror of the bcast tree (partial sums flow
    down the same edges in reverse round order, leaves first)."""
    b = bcast_binomial(n, nbytes, root)
    rounds = [[Transfer(t.dst, t.src, t.nbytes) for t in rnd] for rnd in reversed(b.rounds)]
    return Schedule(f"reduce-binomial[{n}]", n, rounds)


def scatter_binomial(n: int, nbytes: float, root: int = 0) -> Schedule:
    """Binomial scatter: root splits, subtree roots forward halves.

    ``nbytes`` is the per-destination chunk; a subtree root receives
    subtree_size × nbytes in one message.
    """
    rounds: list[list[Transfer]] = []
    mask = n.bit_length() - 1 if (n & (n - 1)) == 0 else n.bit_length()
    # walk masks high→low so messages carry whole subtrees
    m = 1 << (mask - 1) if mask else 0
    holders = {0: n}  # vrank -> number of chunks held
    while m >= 1:
        rnd = []
        new_holders = dict(holders)
        for v, cnt in holders.items():
            peer = v | m
            if peer != v and peer < n and peer not in holders:
                sub = min(cnt - (peer - v), n - peer) if peer - v < cnt else 0
                sub = max(sub, 0)
                if sub > 0:
                    rnd.append(Transfer(_rank(v, root, n), _rank(peer, root, n), sub * nbytes))
                    new_holders[peer] = sub
                    new_holders[v] = cnt - sub
        holders = new_holders
        if rnd:
            rounds.append(rnd)
        m >>= 1
    return Schedule(f"scatter-binomial[{n}]", n, rounds)


def gather_binomial(n: int, nbytes: float, root: int = 0) -> Schedule:
    sc = scatter_binomial(n, nbytes, root)
    rounds = [[Transfer(t.dst, t.src, t.nbytes) for t in rnd] for rnd in reversed(sc.rounds)]
    return Schedule(f"gather-binomial[{n}]", n, rounds)


def allgather_ring(n: int, nbytes: float) -> Schedule:
    """Ring allgather: n-1 rounds of neighbour exchange (rank space)."""
    rounds = []
    for _ in range(n - 1):
        rounds.append([Transfer(i, (i + 1) % n, nbytes) for i in range(n)])
    return Schedule(f"allgather-ring[{n}]", n, rounds)


def reduce_scatter_ring(n: int, nbytes: float) -> Schedule:
    """Ring reduce-scatter: n-1 rounds, each rank forwards a partial chunk."""
    rounds = []
    for _ in range(n - 1):
        rounds.append([Transfer(i, (i + 1) % n, nbytes) for i in range(n)])
    return Schedule(f"reduce-scatter-ring[{n}]", n, rounds)


def allreduce_ring(n: int, nbytes: float) -> Schedule:
    """Ring allreduce = ring reduce-scatter + ring allgather on 1/n chunks."""
    chunk = nbytes / n
    rs = reduce_scatter_ring(n, chunk)
    ag = allgather_ring(n, chunk)
    return Schedule(f"allreduce-ring[{n}]", n, rs.rounds + ag.rounds)


def allreduce_recursive_doubling(n: int, nbytes: float) -> Schedule:
    """Recursive doubling allreduce (MPICH default for short messages)."""
    if n & (n - 1):
        raise ValueError("recursive doubling needs power-of-two n")
    rounds = []
    mask = 1
    while mask < n:
        rnd = []
        for i in range(n):
            rnd.append(Transfer(i, i ^ mask, nbytes))
        rounds.append(rnd)
        mask <<= 1
    return Schedule(f"allreduce-recdbl[{n}]", n, rounds)


def alltoall_pairwise(n: int, nbytes: float) -> Schedule:
    """Pairwise-exchange alltoall (MPICH long-message default).

    Round r (1..n-1): rank i sends its chunk to (i+r) mod n.  ``nbytes`` is
    the per-pair chunk size (the paper's 'unit message size').
    """
    rounds = []
    for r in range(1, n):
        rounds.append([Transfer(i, (i + r) % n, nbytes) for i in range(n)])
    return Schedule(f"alltoall-pairwise[{n}]", n, rounds)


def alltoall_direct(n: int, nbytes: float) -> Schedule:
    """All pairs fire simultaneously in one round — the maximal-contention
    reference point (what a congested static-routed network degrades to)."""
    rnd = [Transfer(i, j, nbytes) for i in range(n) for j in range(n) if i != j]
    return Schedule(f"alltoall-direct[{n}]", n, [rnd])


ALGORITHMS: dict[str, Callable[..., Schedule]] = {
    "bcast": bcast_binomial,
    "reduce": reduce_binomial,
    "scatter": scatter_binomial,
    "gather": gather_binomial,
    "allgather": allgather_ring,
    "reduce_scatter": reduce_scatter_ring,
    "allreduce": allreduce_ring,
    "allreduce_recdbl": allreduce_recursive_doubling,
    "alltoall": alltoall_pairwise,
    "alltoall_direct": alltoall_direct,
}


def default_allreduce(n: int) -> str:
    """The legacy MPICH-style allreduce pick for ``n`` ranks: recursive
    doubling on power-of-two counts, ring reduce-scatter+allgather otherwise.
    The single selection point for every legacy-cost-model caller (netsim's
    graph500 level-sync, benchmark rows)."""
    return "allreduce_recdbl" if n > 1 and (n & (n - 1)) == 0 else "allreduce"


def collective_time(
    g: Graph,
    op: str,
    nbytes: float,
    model: LinkModel = TAISHAN_LINK,
    rt: RoutingTable | None = None,
    root: int | None = None,
    routing: str = "static",
    adaptive: AdaptiveConfig | None = None,
    **kw,
) -> CollectiveReport:
    """Cost collective ``op`` with per-rank payload ``nbytes`` on graph ``g``.

    For rooted collectives (bcast/reduce/scatter/gather) the paper averages
    over all roots; pass root=None to reproduce that averaging.
    ``routing``/``adaptive`` select the routing tier (see :func:`simulate`).
    """
    rt = rt or RoutingTable.build(g)
    fn = ALGORITHMS[op]
    rooted = op in ("bcast", "reduce", "scatter", "gather")
    if rooted and root is None:
        reps = [simulate(fn(g.n, nbytes, root=r, **kw), rt, model,
                         routing=routing, adaptive=adaptive)
                for r in range(g.n)]
        t = float(np.mean([r_.time for r_ in reps]))
        base = reps[0]
        return CollectiveReport(
            schedule=base.schedule + "-rootavg",
            topology=base.topology,
            time=t,
            latency_time=float(np.mean([r_.latency_time for r_ in reps])),
            serial_time=float(np.mean([r_.serial_time for r_ in reps])),
            rounds=base.rounds,
            max_link_bytes=float(np.max([r_.max_link_bytes for r_ in reps])),
            total_link_bytes=float(np.mean([r_.total_link_bytes for r_ in reps])),
        )
    args = {"root": root} if rooted else {}
    sched = fn(g.n, nbytes, **args, **kw)
    return simulate(sched, rt, model, routing=routing, adaptive=adaptive)
