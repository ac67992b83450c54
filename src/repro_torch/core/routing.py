"""Routing tiers: static shortest-path (paper §3.2) and congestion-aware
adaptive multipath (the counterpart of ``repro.core.routing``, a numpy copy
held equal by the tests).

The static table keeps the reference's host Floyd–Warshall: its strict
``<`` visiting order defines which shortest path is *the* static route,
and no BFS distance matrix (such as ``metrics.apsp`` on the device) can
reproduce that choice.

The paper routes every node pair over one fixed shortest path computed by
Floyd–Warshall, which is also where its torus congestion pathology comes
from — static single-path routing concentrates all-to-all flows on a few
links.  ``RoutingTable`` reproduces that behaviour exactly: deterministic
lowest-k tie-breaking, per-pair path extraction, and per-link load
accounting that the simulator (netsim.py) uses for contention.

Beyond the paper, the table also exposes the *full* minimal-candidate set
per (u, v) pair — every neighbour ``w`` of ``u`` with
``dist[w, v] == dist[u, v] - 1`` — which is what the adaptive tier routes
over: :func:`adaptive_link_loads` splits each flow's traffic across its
minimal candidates, weighted by an EWMA-smoothed link-occupancy congestion
score with a one-link lookahead (the NoC-style minimal adaptive recipe:
candidate sets from the routing table, occupancy scores, EWMA smoothing).
Routing only over *minimal* candidates keeps every packet on a DAG towards
its destination, so no escape path is needed for livelock/deadlock safety.
``AdaptiveConfig(gamma=0)`` — zero congestion sensitivity — is defined as
the static tier itself (an oblivious single-path router), which is the
regression anchor the tests pin.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graphs import Graph

__all__ = [
    "RoutingTable",
    "AdaptiveConfig",
    "DEFAULT_ADAPTIVE",
    "adaptive_link_loads",
    "loads_to_dict",
]


@dataclasses.dataclass
class RoutingTable:
    """All-pairs static shortest-path routes for a graph.

    ``dist[u, v]``      hop distance (float, inf if disconnected)
    ``next_hop[u, v]``  neighbour of u on the fixed route u->v (-1 if none)

    The static route is ONE minimal path (the paper's choice); the full
    minimal-candidate sets live behind :meth:`candidates` /
    :meth:`candidate_slots` and are derived from ``dist`` on demand — a
    neighbour ``w`` of ``u`` is a candidate for (u, v) iff
    ``dist[w, v] == dist[u, v] - 1`` (hop counts are exact integers stored
    as floats, so the equality is exact).
    """

    graph: Graph
    dist: np.ndarray
    next_hop: np.ndarray
    _nbr: np.ndarray | None = dataclasses.field(default=None, repr=False)

    @classmethod
    def build(cls, g: Graph) -> "RoutingTable":
        n = g.n
        dist = np.full((n, n), np.inf)
        nxt = np.full((n, n), -1, dtype=np.int64)
        np.fill_diagonal(dist, 0.0)
        for u, v in g.edges:
            dist[u, v] = dist[v, u] = 1.0
            nxt[u, v] = v
            nxt[v, u] = u
        # Floyd–Warshall, vectorized over (i, j) for each k; strict '<' gives
        # deterministic lowest-k tie-breaking (the paper's static choice).
        for k in range(n):
            alt = dist[:, k, None] + dist[None, k, :]
            better = alt < dist - 1e-12
            if better.any():
                dist = np.where(better, alt, dist)
                nxt = np.where(better, nxt[:, k, None], nxt)
        return cls(g, dist, nxt)

    # ------------------------------------------------------------------
    def path(self, u: int, v: int) -> list[int]:
        """Vertex sequence of the static route u -> v (inclusive)."""
        if u == v:
            return [u]
        if self.next_hop[u, v] < 0:
            raise ValueError(f"no route {u}->{v}")
        out = [u]
        cur = u
        while cur != v:
            cur = int(self.next_hop[cur, v])
            out.append(cur)
            if len(out) > self.graph.n + 1:  # pragma: no cover
                raise RuntimeError("routing loop")
        return out

    def path_links(self, u: int, v: int) -> list[tuple[int, int]]:
        """Directed links traversed by the route u -> v."""
        p = self.path(u, v)
        return list(zip(p[:-1], p[1:]))

    # ------------------------------------------------------------------
    # Minimal-candidate sets (the adaptive tier's routing universe)
    # ------------------------------------------------------------------

    def neighbor_table(self) -> np.ndarray:
        """Padded (n, k_max) neighbour table, -1 beyond a node's degree.

        Row ``u`` lists ``u``'s neighbours in ascending order; directed link
        loads in the adaptive tier are indexed (u, slot) against this table.
        Built lazily and cached on the instance.
        """
        if self._nbr is None:
            lists = self.graph.adjacency_lists()
            kmax = max((len(nb) for nb in lists), default=0)
            nbr = np.full((self.graph.n, max(kmax, 1)), -1, dtype=np.int64)
            for u, nb in enumerate(lists):
                nbr[u, : len(nb)] = nb
            self._nbr = nbr
        return self._nbr

    def candidates(self, u: int, v: int) -> list[int]:
        """All minimal next-hops for u -> v (ascending node order).

        Every returned ``w`` satisfies ``dist[w, v] == dist[u, v] - 1``; the
        static ``next_hop[u, v]`` is always one of them.  Empty when u == v
        or v is unreachable from u.
        """
        if u == v or not np.isfinite(self.dist[u, v]):
            return []
        nbr = self.neighbor_table()[u]
        nbr = nbr[nbr >= 0]
        return [int(w) for w in nbr if self.dist[w, v] == self.dist[u, v] - 1.0]

    def candidate_slots(self, nodes: np.ndarray, dsts: np.ndarray) -> np.ndarray:
        """Vectorized candidate mask: (len(nodes), k_max) bool.

        ``mask[i, j]`` is True iff slot ``j`` of ``neighbor_table()[nodes[i]]``
        is a minimal next-hop towards ``dsts[i]``.
        """
        nbr = self.neighbor_table()[nodes]  # (A, kmax)
        valid = nbr >= 0
        d_here = self.dist[nodes, dsts]  # (A,)
        d_next = self.dist[np.where(valid, nbr, 0), dsts[:, None]]  # (A, kmax)
        return valid & (d_next == d_here[:, None] - 1.0)

    # ------------------------------------------------------------------
    def link_loads(self, flows: list[tuple[int, int, float]] | None = None) -> dict[tuple[int, int], float]:
        """Traffic per *directed* link under static routing.

        ``flows`` is a list of (src, dst, bytes); default = one unit flow per
        ordered pair (the all-to-all pattern the paper stresses).
        Returns {(u, v): total_bytes}.
        """
        n = self.graph.n
        if flows is None:
            flows = [(u, v, 1.0) for u in range(n) for v in range(n) if u != v]
        loads: dict[tuple[int, int], float] = {}
        for src, dst, size in flows:
            if src == dst or size == 0.0:
                continue
            for link in self.path_links(src, dst):
                loads[link] = loads.get(link, 0.0) + size
        return loads

    def max_congestion(self, flows=None) -> float:
        loads = self.link_loads(flows)
        return max(loads.values()) if loads else 0.0

    def mean_hops(self, flows=None) -> float:
        n = self.graph.n
        if flows is None:
            off = ~np.eye(n, dtype=bool)
            return float(self.dist[off].mean())
        tot = sum(self.dist[s, d] * 1.0 for s, d, _ in flows)
        return tot / max(len(flows), 1)


# ------------------------------------------------------------------------------
# Adaptive tier: congestion-weighted fractional multipath over the minimal
# candidate sets.
# ------------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Knobs of the adaptive router.

    gamma      congestion sensitivity: candidate weight is
               1 / (1 + gamma * score).  gamma == 0 turns congestion
               feedback off entirely, which by definition IS the static
               single-path tier (the simulator short-circuits to it).
    ewma       smoothing of the per-step link-occupancy score:
               state = ewma * state + (1 - ewma) * step_load.
    lookahead  weight of the next node's best outgoing occupancy in the
               candidate score (the NoC two-hop-lookahead term).
    chunk      destination-batch size of the vectorized sweep (memory knob
               only — results are chunk-size independent because weights
               are frozen within a hop step).
    """

    gamma: float = 8.0
    ewma: float = 0.5
    lookahead: float = 0.5
    chunk: int = 1024


DEFAULT_ADAPTIVE = AdaptiveConfig()


def _static_loads_array(rt: RoutingTable, flows) -> np.ndarray:
    """Static per-link loads folded into the (n, k_max) slot layout."""
    nbr = rt.neighbor_table()
    loads = np.zeros(nbr.shape, dtype=np.float64)
    slot = {(int(u), int(w)): j for u in range(nbr.shape[0])
            for j, w in enumerate(nbr[u]) if w >= 0}
    for (u, w), b in rt.link_loads(flows).items():
        loads[u, slot[(u, w)]] += b
    return loads


def adaptive_link_loads(
    rt: RoutingTable,
    flows: list[tuple[int, int, float]],
    config: AdaptiveConfig = DEFAULT_ADAPTIVE,
    state: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-directed-link traffic under congestion-aware adaptive routing.

    Every flow (src, dst, bytes) is routed over the minimal-candidate DAG
    towards its destination: at each hop step, the traffic mass sitting at a
    node splits across that node's minimal candidates with weights
    ``1 / (1 + gamma * score)``, where ``score`` is the EWMA-smoothed
    occupancy of the outgoing link plus ``lookahead`` times the best
    outgoing occupancy of the candidate node (so congestion two links ahead
    steers traffic too).  All flows advance one hop per step
    simultaneously; the occupancy state updates *between* steps, never
    within one, so the sweep is deterministic and destination-chunk-order
    independent.

    Returns ``(loads, state)``: both (n, k_max) arrays aligned with
    ``rt.neighbor_table()`` — ``loads[u, j]`` is the bytes carried by the
    directed link u -> nbr[u, j], ``state`` the EWMA occupancy to carry
    into a subsequent call (rounds of one collective share it).

    Raises ``ValueError`` when any flow's destination is unreachable.
    With ``config.gamma == 0`` the static single-path loads are returned
    (zero congestion sensitivity == the static tier, exactly).
    """
    nbr = rt.neighbor_table()
    n, kmax = nbr.shape
    if state is None:
        state = np.zeros((n, kmax), dtype=np.float64)
    fl = [(int(s), int(d), float(b)) for s, d, b in flows
          if int(s) != int(d) and float(b) != 0.0]
    if not fl:
        return np.zeros((n, kmax), dtype=np.float64), state
    src = np.array([f[0] for f in fl], dtype=np.int64)
    dst = np.array([f[1] for f in fl], dtype=np.int64)
    size = np.array([f[2] for f in fl], dtype=np.float64)
    hops = rt.dist[src, dst]
    bad = ~np.isfinite(hops)
    if bad.any():
        raise ValueError(
            f"adaptive routing on disconnected graph {rt.graph.name!r}: "
            f"{int(bad.sum())} of {len(fl)} flows have unreachable "
            f"destinations (e.g. {int(src[bad][0])}->{int(dst[bad][0])})")
    if config.gamma == 0.0:
        return _static_loads_array(rt, fl), state

    total = np.zeros((n, kmax), dtype=np.float64)
    valid = nbr >= 0
    # sparse mass state: coalesced (node, dst, mass) triplets
    udst, dinv = np.unique(dst, return_inverse=True)
    key = src * len(udst) + dinv
    ukey, kinv = np.unique(key, return_inverse=True)
    mass = np.zeros(len(ukey), dtype=np.float64)
    np.add.at(mass, kinv, size)
    node = ukey // len(udst)
    dest = udst[ukey % len(udst)]
    state = state.copy()

    for _ in range(int(hops.max())):
        live = node != dest
        if not live.any():
            break
        u, v, m = node[live], dest[live], mass[live]
        # candidate weights, frozen for this whole hop step
        scale = state[valid].mean() if valid.any() else 0.0
        occ = state / scale if scale > 0.0 else np.zeros_like(state)
        best_out = np.where(valid, occ, np.inf).min(axis=1)
        best_out = np.where(np.isfinite(best_out), best_out, 0.0)
        score = occ + config.lookahead * best_out[nbr.clip(min=0)]
        weight = np.where(valid, 1.0 / (1.0 + config.gamma * score), 0.0)

        step = np.zeros((n, kmax), dtype=np.float64)
        nxt_node: list[np.ndarray] = []
        nxt_dest: list[np.ndarray] = []
        nxt_mass: list[np.ndarray] = []
        for lo in range(0, len(u), max(int(config.chunk), 1)):
            sl = slice(lo, lo + max(int(config.chunk), 1))
            uc, vc, mc = u[sl], v[sl], m[sl]
            cand = rt.candidate_slots(uc, vc)  # (A, kmax)
            w = np.where(cand, weight[uc], 0.0)
            frac = w / w.sum(axis=1, keepdims=True)
            flow = frac * mc[:, None]  # (A, kmax) bytes onto each link
            np.add.at(step, (uc[:, None], np.arange(kmax)[None, :]), flow)
            keep = cand & (flow > 0.0)
            nxt_node.append(nbr[uc][keep])
            nxt_dest.append(np.broadcast_to(vc[:, None], cand.shape)[keep])
            nxt_mass.append(flow[keep])
        total += step
        state = config.ewma * state + (1.0 - config.ewma) * step
        # coalesce the advanced mass back into unique (node, dst) triplets
        nn = np.concatenate(nxt_node)
        nd = np.concatenate(nxt_dest)
        nm = np.concatenate(nxt_mass)
        dix = np.searchsorted(udst, nd)
        ukey, kinv = np.unique(nn * len(udst) + dix, return_inverse=True)
        mass = np.zeros(len(ukey), dtype=np.float64)
        np.add.at(mass, kinv, nm)
        node = ukey // len(udst)
        dest = udst[ukey % len(udst)]
    return total, state


def loads_to_dict(rt: RoutingTable, loads: np.ndarray) -> dict[tuple[int, int], float]:
    """(n, k_max) slot loads -> {(u, v): bytes} over actual directed links."""
    nbr = rt.neighbor_table()
    out: dict[tuple[int, int], float] = {}
    for u, j in zip(*np.nonzero(loads)):
        out[(int(u), int(nbr[u, j]))] = float(loads[u, j])
    return out
