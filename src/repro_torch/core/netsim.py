"""Application-level network simulation: the paper's benchmark suite as
explicit traffic models costed on a routed topology (the counterpart of
``repro.core.netsim``, a numpy copy held equal by the tests).

The paper's evidence chain is: topology → (MPL, D, BW) → measured runtime of
ping-pong / MPI collectives / b_eff / FFTE / Graph500 / NPB.  On real hardware
the middle of that chain is the network; here it is ``collectives.simulate``
plus per-application traffic models with a compute term, mirroring the SimGrid
methodology of paper §4.4.2 (8 GFlop/s per core, GigE links, 30 µs latency —
we default to the Taishan-calibrated α–β fit instead).

Every benchmark returns predicted *runtime seconds*; the figures report the
paper's metric — performance ratio to the ring of the same size — which is
``time_ring / time_topo`` (speed is reciprocal runtime).

These are models, not cycle-accurate simulations; they are validated by
reproducing the paper's qualitative orderings (optimal > torus > ... > ring,
torus congestion collapse on alltoall) and magnitudes (see benchmarks/).
"""
from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np

from ..comm import schedules
from . import collectives as C
from .graphs import Graph
from .routing import AdaptiveConfig, RoutingTable
from .traffic import traffic_pattern

__all__ = [
    "Cluster",
    "TAISHAN",
    "pingpong_matrix",
    "pingpong_fit",
    "pingpong_mean_latency",
    "collective_bench",
    "traffic_time",
    "effective_bandwidth",
    "ffte_1d",
    "graph500",
    "npb",
]


# Routing tables are expensive to build (Floyd closure) and every benchmark
# in this module asks for one per call, so they are cached at module level,
# keyed on the graph's identity (n + canonical edge tuple) rather than
# smuggled onto the frozen Cluster dataclass via object.__setattr__ (which
# broke the frozen contract and silently desynced when dataclasses.replace
# copied the hidden attribute).  Bounded LRU (hits move to the back, the
# front is evicted) so an interleaved sweep over more than
# ``_ROUTING_CACHE_MAX`` topologies keeps its hot tables instead of
# rebuilding the Floyd closure on every call, and the cache cannot grow
# without limit.
_ROUTING_CACHE: collections.OrderedDict[tuple[int, tuple], RoutingTable] = (
    collections.OrderedDict())
_ROUTING_CACHE_MAX = 64


def _routing_table(graph: Graph) -> RoutingTable:
    key = (graph.n, graph.edges)
    rt = _ROUTING_CACHE.get(key)
    if rt is None:
        if len(_ROUTING_CACHE) >= _ROUTING_CACHE_MAX:
            _ROUTING_CACHE.popitem(last=False)
        rt = RoutingTable.build(graph)
        _ROUTING_CACHE[key] = rt
    else:
        _ROUTING_CACHE.move_to_end(key)
    return rt


@dataclasses.dataclass(frozen=True)
class Cluster:
    """A topology + link model + per-node compute speed.

    ``routing`` selects the contention tier every benchmark in this module
    is costed under: ``"static"`` (single Floyd path per pair, the paper's
    model) or ``"adaptive"`` (congestion-aware minimal multipath, see
    ``repro_torch.core.routing.adaptive_link_loads``).  ``adaptive`` optionally
    overrides the adaptive tier's ``AdaptiveConfig``.
    """

    graph: Graph
    link: C.LinkModel = C.TAISHAN_LINK
    flops: float = 16e9  # paper SimGrid config: dual-core × 8 GFlop/s
    mem_bw: float = 10e9  # local memory bandwidth (B/s) for memory-bound kernels
    routing: str = "static"
    adaptive: AdaptiveConfig | None = None

    def __post_init__(self) -> None:
        if self.routing not in ("static", "adaptive"):
            raise ValueError(
                f"routing={self.routing!r} must be 'static' or 'adaptive'")

    def routing_table(self) -> RoutingTable:
        # cached per graph in the module-level table above
        return _routing_table(self.graph)

    def _sim_kw(self) -> dict:
        return {"routing": self.routing, "adaptive": self.adaptive}


def TAISHAN(graph: Graph) -> Cluster:
    return Cluster(graph=graph, link=C.TAISHAN_LINK, flops=16e9)


# ------------------------------------------------------------------------------
# Ping-pong (paper §4.2.1, Fig. 2/3)
# ------------------------------------------------------------------------------

def pingpong_matrix(cl: Cluster, nbytes: float = 1024.0) -> np.ndarray:
    """Node-to-node one-way latency matrix for ``nbytes`` messages.

    Raises ``ValueError`` on disconnected graphs: unreachable pairs have
    infinite hop distance, and letting the ``inf`` flow into downstream
    fits (``np.polyfit`` in :func:`pingpong_fit`) silently produced NaN
    coefficients instead of an error.
    """
    rt = cl.routing_table()
    h = rt.dist
    off = ~np.eye(cl.graph.n, dtype=bool)
    bad = int(np.count_nonzero(~np.isfinite(h[off])))
    if bad:
        u, v = np.argwhere(~np.isfinite(h) & off)[0]
        raise ValueError(
            f"graph {cl.graph.name!r} is disconnected: {bad} ordered node "
            f"pairs are unreachable (e.g. {int(u)}->{int(v)}); ping-pong "
            "latency is undefined")
    lat = cl.link.t0 + cl.link.alpha * h + nbytes / cl.link.bw * h
    np.fill_diagonal(lat, 0.0)
    return lat


def pingpong_fit(cl: Cluster, nbytes: float = 1024.0) -> tuple[float, float, float]:
    """Linear fit T = T0 + α·h over node pairs. Returns (T0, α, pearson ρ)."""
    rt = cl.routing_table()
    lat = pingpong_matrix(cl, nbytes)
    n = cl.graph.n
    off = ~np.eye(n, dtype=bool)
    x = rt.dist[off]
    y = lat[off]
    a, b = np.polyfit(x, y, 1)
    rho = float(np.corrcoef(x, y)[0, 1])
    return float(b), float(a), rho


def pingpong_mean_latency(cl: Cluster, nbytes: float = 1024.0) -> float:
    n = cl.graph.n
    off = ~np.eye(n, dtype=bool)
    return float(pingpong_matrix(cl, nbytes)[off].mean())


# ------------------------------------------------------------------------------
# MPI collectives (paper §4.2.2, Fig. 4)
# ------------------------------------------------------------------------------

def collective_bench(cl: Cluster, op: str, unit_bytes: float,
                     schedule: str = "legacy") -> float:
    """Predicted runtime of one collective with the paper's message sizing.

    For bcast/reduce: every rank's buffer is ``unit_bytes``.  For scatter and
    alltoall the per-pair chunk is ``unit_bytes`` (paper: 'transfer message
    sizes are either equal to the unit message sizes or the unit sizes
    multiplied by the number of nodes, depending on whether it is the root').

    ``schedule`` picks the cost model: ``"legacy"`` prices the rank-space
    algorithms in ``repro_torch.core.collectives`` (the paper's hop-count
    heuristics); ``"synth"`` synthesizes a per-topology schedule via
    ``repro_torch.comm.schedules`` for the ops that subsystem covers (bcast /
    reduce / scatter / gather / allreduce) and falls back to legacy for the
    rest (alltoall, *_recdbl variants).
    """
    if schedule not in ("legacy", "synth"):
        raise ValueError(f"schedule={schedule!r} must be 'legacy' or 'synth'")
    if schedule == "synth":
        if op in schedules.SYNTH_OPS:
            # schedule synthesis prices candidates under the static tier
            # (its search already adapts the schedule to the topology)
            return schedules.synthesized_time(
                cl.graph, op, unit_bytes, model=cl.link, rt=cl.routing_table()).time
    return C.collective_time(cl.graph, op, unit_bytes, model=cl.link,
                             rt=cl.routing_table(), **cl._sim_kw()).time


# ------------------------------------------------------------------------------
# Synthetic traffic sweeps (adaptive-routing scenario tier)
# ------------------------------------------------------------------------------

def traffic_time(cl: Cluster, pattern: str, nbytes: float = 1 << 20,
                 rounds: int = 1, seed: int = 0, **kw) -> float:
    """Predicted completion time of a synthetic traffic pattern.

    ``pattern`` names a generator in ``repro_torch.core.traffic`` (``uniform`` /
    ``transpose`` / ``shift`` / ``hotspot`` / ``random-perm``); each round
    injects the same flow set (``nbytes`` per flow) and is costed under the
    cluster's routing tier, so static vs adaptive comparisons are a single
    ``dataclasses.replace(cl, routing=...)`` apart.
    """
    flows = traffic_pattern(pattern, cl.graph.n, seed=seed, **kw)
    rt = cl.routing_table()
    rnd = [C.Transfer(s, d, float(nbytes)) for s, d in flows]
    sched = C.Schedule(f"traffic-{pattern}", cl.graph.n, [list(rnd) for _ in range(rounds)])
    return C.simulate(sched, rt, cl.link, **cl._sim_kw()).time


# ------------------------------------------------------------------------------
# Effective bandwidth b_eff (paper §4.2.3, Fig. 5)
# ------------------------------------------------------------------------------

def effective_bandwidth(
    cl: Cluster,
    mem_per_node: float = 8 << 30,
    n_sizes: int = 21,
    n_random: int = 6,
    seed: int = 0,
) -> float:
    """b_eff (bytes/s): average over ring + random patterns and 21 sizes.

    Pattern model (per b_eff spec): several 'rings' (rank-space neighbour
    exchanges at various strides) and random permutations; each pattern is a
    set of simultaneous pairwise flows.  b_eff per measurement = Σ bytes /
    completion time; final value = average over patterns and sizes (max over
    methods is folded into using the best-case single round per pattern).
    """
    rng = np.random.default_rng(seed)
    rt = cl.routing_table()
    n = cl.graph.n
    max_size = mem_per_node / 128.0
    sizes = np.logspace(0, math.log10(max_size), n_sizes)

    patterns: list[list[tuple[int, int]]] = []
    for stride in (1, 2, 3):  # ring patterns, natural order
        patterns.append([(i, (i + stride) % n) for i in range(n)])
    for _ in range(n_random):  # random permutation patterns
        perm = rng.permutation(n)
        patterns.append([(i, int(perm[i])) for i in range(n) if i != perm[i]])

    beffs = []
    for size in sizes:
        for pat in patterns:
            sched = C.Schedule("beff-pat", n, [[C.Transfer(s, d, float(size)) for s, d in pat]])
            rep = C.simulate(sched, rt, cl.link, **cl._sim_kw())
            total = size * len(pat)
            beffs.append(total / rep.time)
    return float(np.mean(beffs))


# ------------------------------------------------------------------------------
# FFTE 1-D parallel FFT (paper §4.2.4, Fig. 6)
# ------------------------------------------------------------------------------

def ffte_1d(cl: Cluster, array_len: int) -> float:
    """Parallel 1-D complex FFT runtime: local FFT + global transpose.

    Takahashi's 6-step FFT does 3 all-to-all transposes of the full array for
    arrays ≫ cache; compute is 5·N·log2(N) flops split across nodes.  Each
    transpose moves N·16 bytes (complex128) total, i.e. per-pair chunks of
    N·16/n² bytes in an alltoall.
    """
    n = cl.graph.n
    total_bytes = array_len * 16.0
    chunk = total_bytes / (n * n)
    t_a2a = C.collective_time(cl.graph, "alltoall", chunk, model=cl.link,
                              rt=cl.routing_table(), **cl._sim_kw()).time
    flops = 5.0 * array_len * math.log2(max(array_len, 2))
    t_comp = flops / (cl.flops * n)
    # memory-bound bit-reversal/pack passes: ~4 sweeps of the local slice
    t_mem = 4.0 * (total_bytes / n) / cl.mem_bw
    return 3.0 * t_a2a + t_comp + t_mem


# ------------------------------------------------------------------------------
# Graph500 BFS/SSSP (paper §4.2.5, Fig. 7)
# ------------------------------------------------------------------------------

def graph500(cl: Cluster, scale: int = 27, edgefactor: int = 16, op: str = "bfs") -> float:
    """Predicted time of one Graph500 search (TEPS⁻¹ × edges).

    Level-synchronous distributed BFS: every level exchanges frontier edges
    with essentially random destinations (an alltoallv), plus an allreduce to
    detect termination.  Traffic: each of E = edgefactor·2^scale edges crosses
    the network once with ~8 bytes (48-bit packed vertex + payload); SSSP
    (delta-stepping) re-visits edges ~2.5× and adds weight bytes.
    """
    n = cl.graph.n
    nvert = 1 << scale
    nedge = edgefactor * nvert
    bytes_per_edge = 8.0 if op == "bfs" else 12.0
    revisit = 1.0 if op == "bfs" else 2.5
    total_bytes = nedge * bytes_per_edge * revisit
    levels = max(int(math.log2(nvert) * 0.75), 8)  # Kronecker graphs: shallow BFS
    chunk = total_bytes / levels / (n * n)
    t_level_a2a = C.collective_time(cl.graph, "alltoall", chunk, model=cl.link,
                                    rt=cl.routing_table(), **cl._sim_kw()).time
    t_level_sync = C.collective_time(cl.graph, C.default_allreduce(n), 8.0,
                                     model=cl.link, rt=cl.routing_table(),
                                     **cl._sim_kw()).time
    # local edge inspection is memory-bound: ~16 B per edge over local share
    t_mem = revisit * nedge * 16.0 / n / cl.mem_bw
    return levels * (t_level_a2a + t_level_sync) + t_mem


# ------------------------------------------------------------------------------
# NAS Parallel Benchmarks (paper §4.2.6, Fig. 8)
# ------------------------------------------------------------------------------

_NPB_CLASS = {  # problem-size parameters per class
    "S": 14, "A": 23, "B": 25, "C": 27,
}


def npb(cl: Cluster, kernel: str, klass: str = "A") -> float:
    """Traffic models for IS / CG / MG / FT / LU (one benchmark iteration set).

    Communication skeletons from the NPB papers:
      IS: 10 iterations × (alltoall of key histogram slices + allreduce)
      FT: ~20 iterations × 3D-FFT transpose alltoall
      CG: 75 iterations × (row/col halo exchanges + 2 dot-product allreduce)
      MG: V-cycles with nearest-neighbour halos across levels + tiny allreduce
      LU: wavefront pipelining: many small nearest-neighbour messages
    """
    n = cl.graph.n
    rt = cl.routing_table()
    kw = cl._sim_kw()
    s = _NPB_CLASS[klass.upper()]
    if kernel == "is":
        nkeys = 1 << s
        iters = 10
        total = nkeys * 4.0  # int32 keys cross the wire once per iteration
        chunk = total / (n * n)
        t = C.collective_time(cl.graph, "alltoall", chunk, model=cl.link, rt=rt, **kw).time
        t += C.collective_time(cl.graph, C.default_allreduce(n), 1024.0 * 4,
                               model=cl.link, rt=rt, **kw).time
        t_mem = 6.0 * nkeys * 4.0 / n / cl.mem_bw  # counting + rank + permute sweeps
        return iters * (t + t_mem)
    if kernel == "ft":
        nx = 1 << ((s + 2) // 3)
        total = (1 << s) * 16.0  # complex grid
        iters = 20
        chunk = total / (n * n)
        t = C.collective_time(cl.graph, "alltoall", chunk, model=cl.link, rt=rt, **kw).time
        flops = 5.0 * (1 << s) * s
        return iters * (t + flops / (cl.flops * n) + 2.0 * (total / n) / cl.mem_bw)
    if kernel == "cg":
        na = {"S": 1400, "A": 14000, "B": 75000, "C": 150000}[klass.upper()]
        iters = 75
        # 2D process grid: exchanges along rows (log n stages of vector halves)
        vec = na * 8.0
        stages = max(int(math.log2(n)), 1)
        t_halo = 0.0
        for st in range(stages):
            peer = lambda i: i ^ (1 << st) if (i ^ (1 << st)) < n else i
            pat = [(i, peer(i)) for i in range(n) if peer(i) != i]
            sched = C.Schedule("cg-halo", n, [[C.Transfer(a, b, vec / n) for a, b in pat]])
            t_halo += C.simulate(sched, rt, cl.link, **kw).time
        t_dot = 2 * C.collective_time(cl.graph, C.default_allreduce(n), 8.0,
                                      model=cl.link, rt=rt, **kw).time
        nz_per = na * 11 / n
        t_mem = nz_per * 20.0 / cl.mem_bw  # SpMV is memory bound
        return iters * (t_halo + t_dot + t_mem)
    if kernel == "mg":
        nx = {"S": 32, "A": 256, "B": 256, "C": 512}[klass.upper()]
        levels = int(math.log2(nx))
        iters = {"S": 4, "A": 4, "B": 20, "C": 20}[klass.upper()]
        t = 0.0
        for lv in range(levels, 0, -1):
            face = (1 << lv) ** 2 * 8.0 / max(n ** (2 / 3), 1)
            pat = [(i, (i + 1) % n) for i in range(n)]
            sched = C.Schedule("mg-halo", n, [[C.Transfer(a, b, face) for a, b in pat]])
            t += 2 * C.simulate(sched, rt, cl.link, **kw).time
        t += C.collective_time(cl.graph, C.default_allreduce(n), 8.0,
                               model=cl.link, rt=rt, **kw).time
        grid = (nx ** 3) / n
        t_mem = 8.0 * grid * 8.0 / cl.mem_bw
        return iters * (t + t_mem)
    if kernel == "lu":
        nx = {"S": 12, "A": 64, "B": 102, "C": 162}[klass.upper()]
        iters = {"S": 50, "A": 250, "B": 250, "C": 250}[klass.upper()]
        # wavefront: 2·nx small messages to rank-space neighbours per sweep
        msg = 5 * nx * 8.0
        pat = [(i, (i + 1) % n) for i in range(n)]
        sched = C.Schedule("lu-pipe", n, [[C.Transfer(a, b, msg) for a, b in pat]])
        t_comm = 2 * nx * C.simulate(sched, rt, cl.link, **kw).time / n
        flops = 150.0 * nx ** 3
        return iters * (t_comm + flops / (cl.flops * n))
    raise ValueError(f"unknown NPB kernel {kernel!r}")
