"""Topology discovery (the counterpart of ``repro.core.search``): the
paper's Algorithm 1 and the symmetry-restricted large-N tier.

Small n, on the host:

1. ``exhaustive_search``: enumerate ring + perfect-matching chord graphs
   (k = 3, optionally girth-pruned) and keep the min-MPL one.
2. ``sa_search``: the paper's Algorithm 1, simulated annealing over
   non-ring 2-edge swaps of a random Hamiltonian regular graph, R replicas
   with periodic best-replica exchange, each swap priced by
   ``metrics.IncrementalAPSP``; ``sa_objective_search`` anneals an
   arbitrary objective.  The dense state is tens of kilobytes at the
   n <= 64 this tier serves and a proposal costs microseconds, below one
   kernel launch, so these tiers stay numpy.

Large n, on the device: ``large_search(n, k)`` runs a circulant warm start
(a pinned offset set, or the hillclimb ``circulant_search``), then a polish
warm-started from it: with ``replicas=1`` (the default)
``symmetric_sa_search``, one annealing chain whose orbit swaps
``metrics.SymmetricAPSP`` prices incrementally on the device; with
``replicas=R >= 2`` ``_replica_polish``, R lockstep chains whose R*M
proposals per iteration are priced in one device dispatch through
``core.engines.cuda_sweep``.  Both price through the hand-written CUDA
kernels on a CUDA device and through their plain PyTorch versions when the
caller passes ``device="cpu"``.  The hillclimb prices its candidates with
the numpy pricer, or in batches on the device (``engines.torch_circulant``,
picked at n >= 4096).

The randomness is the reference's: host numpy Generators,
``default_rng(seed)`` in the hillclimb, the single-chain polish and
``sa_objective_search``, and ``default_rng([seed, r])`` per replica chain
(``sa_search`` and the replica polish), consumed in the same order, and
every accept is decided on exact integer hop totals.  So per seed the port
follows the reference's trajectory bit for bit and returns the same graph.
``SearchResult``, ``KNOWN_OPTIMAL_MPL``, ``_mpl_fast``, ``_graph_mpl_d``,
``exhaustive_search``, ``_edge_swap``, ``_Replica``, ``_chord_array``,
``_sa_chunk_py``, ``sa_search``, ``sa_objective_search``,
``_circulant_profile``, ``circulant_search``, ``_orbit``,
``_draw_orbit_swap``, ``_symmetric_random_start``, ``_circulant_orbits``
and ``symmetric_sa_search`` are copies of the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from . import metrics
from .engines import cuda_sweep, torch_circulant
from .graphs import Graph, circulant, from_edges, random_hamiltonian_regular, ring
from .known_optimal import KNOWN_CIRCULANT_OFFSETS

__all__ = ["SearchResult", "sa_search", "exhaustive_search", "sa_objective_search",
           "circulant_search", "large_search", "symmetric_sa_search", "KNOWN_OPTIMAL_MPL"]

# Published MPL values for optimal graphs (paper TABLE 1/2) — used as search
# targets and test ground truth.
KNOWN_OPTIMAL_MPL = {
    (16, 3): 2.20,
    (16, 4): 1.75,
    (32, 3): 2.94,
    (32, 4): 2.35,
    (20, 4): 1.95,
    (30, 5): 1.97,
    (36, 5): 2.14,
}


@dataclasses.dataclass
class SearchResult:
    graph: Graph
    mpl: float
    diameter: float
    mpl_lb: float
    d_lb: int
    iterations: int
    accepted: int
    history: list[float]  # best-so-far MPL trace (sparse)
    replicas: int = 1
    evals_delta: int = 0  # incremental evaluations (delta path)
    evals_full: int = 0  # full-recompute fallbacks
    device_dispatches: int = 0  # device pricing dispatches (replica polish)
    offsets: tuple[int, ...] | None = None  # circulant offsets, if applicable
    compound_steps: int = 0  # multi-orbit proposals priced (moves_per_step > 1)
    objective_value: float | None = None  # non-MPL objective score (e.g.
    # synthesized collective-schedule seconds for objective="collective-time")

    @property
    def mpl_gap(self) -> float:
        return self.mpl - self.mpl_lb

    @property
    def d_gap(self) -> float:
        return self.diameter - self.d_lb


def _graph_mpl_d(g: Graph) -> tuple[float, float]:
    return _mpl_fast(g.adjacency())


# --------------------------------------------------------------------------------
# Tier 1: exhaustive (tiny graphs)
# --------------------------------------------------------------------------------

def exhaustive_search(
    n: int,
    k: int,
    girth_min: int = 3,
    limit: int = 2_000_000,
) -> SearchResult:
    """Exhaustive search over ring + chord-set graphs for tiny (n, k).

    We enumerate Hamiltonian k-regular graphs (ring + (k-2)-regular chord
    graph).  For k=3 the chords are a perfect matching — tractable up to
    n≈16.  A ``girth_min`` constraint prunes, mirroring the paper's use of
    girth to cut the (32,3) space from 1e13 to 1e5.
    """
    if k != 3:
        raise NotImplementedError("exhaustive tier implemented for k=3 (matching chords)")
    ring_edges = [(i, (i + 1) % n) for i in range(n)]
    best: tuple[float, float, Graph] | None = None
    count = 0

    verts = list(range(n))

    def matchings(avail: list[int]):
        if not avail:
            yield []
            return
        u = avail[0]
        for j in range(1, len(avail)):
            v = avail[j]
            if (v - u) % n in (1, n - 1):
                continue  # ring edge
            rest = avail[1:j] + avail[j + 1 :]
            for m in matchings(rest):
                yield [(u, v)] + m

    for chords in matchings(verts):
        count += 1
        if count > limit:
            break
        g = from_edges(n, ring_edges + chords, f"({n},{k})-cand")
        if girth_min > 3 and metrics.girth(g) < girth_min:
            continue
        mp, dia = _graph_mpl_d(g)
        if best is None or (mp, dia) < (best[0], best[1]):
            best = (mp, dia, g.with_name(f"({n},{k})-Optimal"))
    assert best is not None
    mp, dia, g = best
    return SearchResult(
        graph=g,
        mpl=mp,
        diameter=dia,
        mpl_lb=metrics.mpl_lower_bound(n, k),
        d_lb=metrics.diameter_lower_bound(n, k),
        iterations=count,
        accepted=count,
        history=[mp],
    )


# --------------------------------------------------------------------------------
# Tier 2: the paper's Algorithm 1 — SA with edge swap
# --------------------------------------------------------------------------------

def _edge_swap(adj: np.ndarray, ring_mask: np.ndarray, rng: np.random.Generator):
    """Propose a 2-edge swap on non-ring edges, in place on a copy.

    Pick edges (a,b), (c,d) not on the ring, replace with (a,c),(b,d) or
    (a,d),(b,c) — preserves degrees.  Returns the new adjacency or None if the
    proposal is invalid (duplicate/self edge).
    """
    n = adj.shape[0]
    iu, ju = np.where(np.triu(adj & ~ring_mask))
    if len(iu) < 2:
        return None
    e1, e2 = rng.choice(len(iu), size=2, replace=False)
    a, b = int(iu[e1]), int(ju[e1])
    c, d = int(iu[e2]), int(ju[e2])
    if len({a, b, c, d}) != 4:
        return None
    if rng.integers(2):
        p1, p2 = (a, c), (b, d)
    else:
        p1, p2 = (a, d), (b, c)
    if adj[p1] or adj[p2]:
        return None
    out = adj.copy()
    out[a, b] = out[b, a] = False
    out[c, d] = out[d, c] = False
    out[p1] = out[p1[::-1]] = True
    out[p2] = out[p2[::-1]] = True
    return out


class _Replica:
    """One annealing chain: incremental-APSP state + chord list + best."""

    __slots__ = ("ev", "chords", "best_adj", "cur_total", "cur_diam",
                 "best_total", "best_diam", "t", "rng",
                 "hist_iters", "hist_totals", "hist_io", "accepted")

    def __init__(self, adj: np.ndarray, ring_mask: np.ndarray,
                 t_start: float, rng: np.random.Generator, n_iter: int):
        self.ev = metrics.IncrementalAPSP(adj)
        self.chords = _chord_array(adj, ring_mask)
        self.best_adj = adj.copy()
        self.cur_total = self.best_total = self.ev.total
        self.cur_diam = self.best_diam = self.ev.diam
        self.t = t_start
        self.rng = rng
        cap = max(n_iter, 1)
        self.hist_iters = np.empty(cap, dtype=np.int32)
        self.hist_totals = np.empty(cap, dtype=np.int64)
        self.hist_io = np.asarray([cap, 0], dtype=np.int32)
        self.accepted = 0

    def load_best_of(self, other: "_Replica", ring_mask: np.ndarray) -> None:
        """Replica exchange: adopt another chain's best state as current."""
        self.ev.adj[...] = other.best_adj
        self.ev.reset()
        self.chords = _chord_array(self.ev.adj, ring_mask)
        self.cur_total, self.cur_diam = self.ev.total, self.ev.diam


def _chord_array(adj: np.ndarray, ring_mask: np.ndarray) -> np.ndarray:
    iu, ju = np.nonzero(np.triu(adj & ~ring_mask))
    return np.ascontiguousarray(np.stack([iu, ju], axis=1).astype(np.int32))


def _sa_chunk_py(rep: _Replica, n: int, de1, de2, dorient, du,
                 gamma: float, target_total: int, iter_base: int, norm: float) -> int:
    """The annealing inner loop over one chunk of pre-drawn randomness: the
    reference's pure-python mirror of its C ``sa_chunk`` (the same
    trajectory as either of the reference's paths)."""
    ev = rep.ev
    done = 0
    for i in range(len(de1)):
        rep.t *= gamma
        done = i + 1
        e1, e2 = int(de1[i]), int(de2[i])
        if e1 == e2:
            continue
        a, b = int(rep.chords[e1, 0]), int(rep.chords[e1, 1])
        c, d = int(rep.chords[e2, 0]), int(rep.chords[e2, 1])
        if a == c or a == d or b == c or b == d:
            continue
        p1, p2 = ((a, c), (b, d)) if dorient[i] else ((a, d), (b, c))
        if ev.adj[p1] or ev.adj[p2]:
            continue
        tok = ev.evaluate_swap([(a, b), (c, d)], [p1, p2])
        if tok.diam >= n:  # disconnected: dm = +inf, always rejected
            continue
        dm = (tok.total - rep.cur_total) / norm
        if not dm < 0.0:
            if not du[i] < math.exp(-dm / max(rep.t, 1e-12)):
                continue
        ev.commit(tok)
        rep.chords[e1] = p1
        rep.chords[e2] = p2
        rep.cur_total, rep.cur_diam = tok.total, ev.diam
        rep.accepted += 1
        if (rep.cur_total, rep.cur_diam) < (rep.best_total, rep.best_diam):
            rep.best_total, rep.best_diam = rep.cur_total, rep.cur_diam
            rep.best_adj[...] = ev.adj
            cnt = int(rep.hist_io[1])
            if cnt < int(rep.hist_io[0]):
                rep.hist_iters[cnt] = iter_base + i
                rep.hist_totals[cnt] = rep.cur_total
                rep.hist_io[1] = cnt + 1
            if 0 <= target_total and rep.best_total <= target_total:
                break
    return done


def _run_chunk(rep: _Replica, n: int, chunk: int, iter_base: int,
               gamma: float, target_total: int, norm: float) -> int:
    """Draw this chunk's randomness from the replica stream and execute it.

    The draws are the reference's, in its order, whichever of its paths it
    takes; the loop is always its python mirror (the C ``sa_chunk`` has no
    counterpart), so the trajectory is the same."""
    m_c = max(len(rep.chords), 1)
    ints = rep.rng.integers(0, [m_c, m_c, 2], size=(chunk, 3))
    de1 = np.ascontiguousarray(ints[:, 0], dtype=np.int32)
    de2 = np.ascontiguousarray(ints[:, 1], dtype=np.int32)
    dorient = np.ascontiguousarray(ints[:, 2], dtype=np.int32)
    du = rep.rng.random(chunk)
    if len(rep.chords) < 2:
        return chunk  # no swappable chords (k == 2): pure cooling
    return _sa_chunk_py(rep, n, de1, de2, dorient, du, gamma, target_total,
                        iter_base, norm)


def sa_search(
    n: int,
    k: int,
    seed: int = 0,
    n_iter: int = 4000,
    t_start: float = 0.1,
    t_end: float = 1e-4,
    target_mpl: float | None = None,
    start: Graph | None = None,
    replicas: int = 1,
    exchange_every: int = 400,
) -> SearchResult:
    """Paper Algorithm 1, rebuilt: parallel-replica SA with incremental MPL.

    ``replicas`` independent chains anneal under the shared schedule, each on
    its own PRNG stream (``[seed, r]``); every ``exchange_every`` iterations
    the globally best state replaces the worst chain.  Replica 0 is never
    overwritten, so its trajectory is bit-identical to a ``replicas=1`` run
    with the same seed — best-of-R can only improve on it.

    Swap pricing is ``metrics.IncrementalAPSP`` delta evaluation on the
    host, and the inner loop is the reference's python mirror of its C
    ``sa_chunk``: both of the reference's paths consume the same pre-drawn
    streams, so every field of the result equals the reference's per seed.
    The dense (n, n) state is tens of kilobytes at the n <= 64 this tier
    serves and a proposal costs microseconds, below one kernel launch, so
    the tier stays on the host (the row-restricted device state is
    ``symmetric_sa_search``'s).
    """
    ring_mask = ring(n).adjacency()
    gamma = math.exp(math.log(t_end / t_start) / n_iter) if n_iter else 1.0
    norm = n * (n - 1)
    lb = metrics.mpl_lower_bound(n, k)
    tgt = target_mpl if target_mpl is not None else lb
    target_total = math.floor((tgt + 1e-9) * norm + 1e-9)

    reps: list[_Replica] = []
    for r in range(replicas):
        # a generous retry cap: some (n, k, seed) streams need >500 pairing
        # draws (e.g. (30,5) seed [0,1]); extra tries only consume the stream
        # after the old cap would have errored, so existing trajectories are
        # untouched
        g0 = start or random_hamiltonian_regular(n, k, seed=[seed, r],
                                                 max_tries=20000)
        reps.append(_Replica(g0.adjacency(), ring_mask, t_start,
                             np.random.default_rng([seed, r]), n_iter))

    done = 0
    hit = min(rep.best_total for rep in reps) <= target_total
    while done < n_iter and not hit:
        chunk = min(exchange_every, n_iter - done)
        for rep in reps:
            _run_chunk(rep, n, chunk, done, gamma, target_total, norm)
            if rep.best_total <= target_total:
                hit = True
                break
        done += chunk
        if hit or done >= n_iter:
            break
        if replicas > 1:
            gb = min(range(replicas),
                     key=lambda r: (reps[r].best_total, reps[r].best_diam, r))
            worst = max(range(1, replicas),
                        key=lambda r: (reps[r].cur_total, reps[r].cur_diam, -r))
            if (reps[gb].best_total, reps[gb].best_diam) < \
                    (reps[worst].cur_total, reps[worst].cur_diam):
                reps[worst].load_best_of(reps[gb], ring_mask)

    gb = min(range(replicas), key=lambda r: (reps[r].best_total, reps[r].best_diam, r))
    best = reps[gb]
    iu, ju = np.where(np.triu(best.best_adj))
    g = from_edges(n, zip(iu.tolist(), ju.tolist()), f"({n},{k})-Optimal-SA")

    # merged best-so-far trace across replicas (running global minimum)
    events = sorted(
        (int(it), int(tot))
        for rep in reps
        for it, tot in zip(rep.hist_iters[: int(rep.hist_io[1])],
                           rep.hist_totals[: int(rep.hist_io[1])])
    )
    history = []
    running = float("inf")
    for _, tot in events:
        if tot < running:
            running = tot
            history.append(tot / norm)

    return SearchResult(
        graph=g,
        mpl=best.best_total / norm,
        diameter=float(best.best_diam),
        mpl_lb=lb,
        d_lb=metrics.diameter_lower_bound(n, k),
        iterations=n_iter,
        accepted=sum(rep.accepted for rep in reps),
        history=history or [best.best_total / norm],
        replicas=replicas,
        evals_delta=int(sum(rep.ev.n_delta for rep in reps)),
        evals_full=int(sum(rep.ev.n_full for rep in reps)),
    )


def sa_objective_search(
    n: int,
    k: int,
    objective,
    seed: int = 0,
    n_iter: int = 4000,
    t_start: float = 0.1,
    t_end: float = 1e-4,
    start: Graph | None = None,
) -> Graph:
    """SA over edge swaps minimizing an arbitrary ``objective(Graph) -> float``.

    Used for reconstructions (e.g. pinning a graph that matches published
    invariants) and for the beyond-paper layout optimization.
    """
    rng = np.random.default_rng(seed)
    g0 = start or random_hamiltonian_regular(n, k, seed=seed)
    adj = g0.adjacency()
    ring_mask = ring(n).adjacency()
    gamma = math.exp(math.log(t_end / t_start) / n_iter)

    def to_graph(a):
        iu, ju = np.where(np.triu(a))
        return from_edges(n, zip(iu.tolist(), ju.tolist()), f"({n},{k})-obj")

    cur = objective(to_graph(adj))
    best_adj, best = adj.copy(), cur
    t = t_start
    for _ in range(n_iter):
        prop = _edge_swap(adj, ring_mask, rng)
        t *= gamma
        if prop is None:
            continue
        val = objective(to_graph(prop))
        dv = val - cur
        if dv < 0 or rng.random() < math.exp(-dv / max(t, 1e-12)):
            adj, cur = prop, val
            if cur < best:
                best_adj, best = adj.copy(), cur
                if best <= 0:
                    break
    return to_graph(best_adj)


# --------------------------------------------------------------------------------
# Circulant warm start
# --------------------------------------------------------------------------------

def _circulant_profile(n: int, offsets) -> tuple[float, float]:
    """(MPL, diameter) of C_n(offsets) via implicit np.roll BFS from vertex 0.

    Vertex-transitivity means one BFS gives the global MPL/diameter; working
    on the offset list directly (no Graph/edge-list materialisation) makes a
    candidate evaluation O(D * k * n) vector ops — thousands of candidates
    per second at n = 1024.
    """
    shifts = sorted({s % n for s in offsets} - {0})
    shifts = list({sh for s in shifts for sh in (s, n - s)})
    reach = np.zeros(n, dtype=bool)
    reach[0] = True
    frontier = reach.copy()
    total = 0
    count = 1
    d = 0
    while count < n:
        nxt = np.zeros(n, dtype=bool)
        for s in shifts:
            nxt |= np.roll(frontier, s)
        newf = nxt & ~reach
        c = int(newf.sum())
        if c == 0:
            return float("inf"), float("inf")
        d += 1
        total += d * c
        count += c
        reach |= newf
        frontier = newf
    return total / (n - 1), float(d)


CIRCULANT_ENGINES = ("numpy", "torch")


def _resolve_circulant(engine: str, n: int) -> str:
    """The hillclimb's candidate pricer: ``"auto"`` picks ``"torch"`` (the
    batched device sweep) at n >= 4096, where batch pricing amortises, and
    ``"numpy"`` (one candidate at a time on the host) below."""
    if engine == "auto":
        return "torch" if n >= 4096 else "numpy"
    if engine not in CIRCULANT_ENGINES:
        raise ValueError(f"engine={engine!r} must be 'auto', 'numpy' or 'torch'")
    return engine


def circulant_search(
    n: int,
    k: int,
    seed: int = 0,
    n_iter: int = 300,
    include_ring: bool = True,
    engine: str = "auto",
    device=None,
) -> SearchResult:
    """Random-restart hillclimb over circulant offset sets.

    Circulants are Hamiltonian (offset 1 in the set) with full rotational
    symmetry — the subspace the paper searches for 252/256/264-vertex graphs.
    Candidates are priced by ``_circulant_profile`` (implicit BFS on the
    offset list, no graph construction), so 512/1024-vertex searches finish
    in seconds.

    ``engine`` selects the candidate pricer: ``"numpy"`` prices candidates
    one at a time on the host; ``"torch"`` batches each position sweep
    through ``engines.torch_circulant`` on ``device`` (``None`` is the CUDA
    device, resolved only when this pricer is picked); ``"auto"`` picks
    ``"torch"`` at n >= 4096 and ``"numpy"`` below, as the reference picks
    its ``"jax"`` pricer.  The pricers return identical values and
    candidates are accepted in the same order, so the trajectory (and the
    result) is the reference's at a given seed whatever engine either used.
    """
    engine = _resolve_circulant(engine, n)
    dev = resolve_device(device) if engine == "torch" else None
    rng = np.random.default_rng(seed)
    half = k // 2
    has_anti = k % 2 == 1  # odd degree needs the antipodal offset n/2
    if has_anti and n % 2:
        raise ValueError("odd k needs even n")

    def full_offsets(offsets) -> list[int]:
        offs = ([1] if include_ring else []) + sorted(offsets)
        if has_anti:
            offs = offs + [n // 2]
        return offs

    def mpl_of(offsets) -> tuple[float, float]:
        offs = full_offsets(offsets)
        if len(set(offs)) != len(offs):
            return float("inf"), float("inf")
        return _circulant_profile(n, offs)

    n_free = half - (1 if include_ring else 0)
    lo, hi = 2, n // 2 - (1 if has_anti else 0)
    pool = list(range(lo, hi))
    if n_free > len(pool):
        raise ValueError(f"degree {k} too large for circulant on {n} vertices")
    best_offs: list[int] | None = None
    best = (float("inf"), float("inf"))
    history: list[float] = []
    it = 0
    restarts = max(1, n_iter // 50)
    for _ in range(restarts):
        offs = sorted(rng.choice(pool, size=n_free, replace=False).tolist()) if n_free else []
        cur = mpl_of(offs)
        improved = True
        while improved and it < n_iter:
            improved = False
            for pos in range(len(offs)):
                # exhaustive sweep of the position when affordable, else a
                # random subsample (the paper's large-space regime)
                cands = pool if len(pool) * len(offs) <= n_iter else \
                    rng.permutation(pool)[: min(32, len(pool))]
                cands = [int(c) for c in cands]
                # price the unexamined tail against the current offsets in
                # one lazy batch; an acceptance mid-sweep restarts the tail
                # against the new base — exactly the sequential semantics,
                # so numpy and torch pricing follow the same trajectory
                i = 0
                while i < len(cands):
                    tail = cands[i:]
                    # one eligibility pass drives both the batch and its
                    # consumption, so the vals iterator cannot desync:
                    # trials[j] is None for skipped candidates (already in
                    # offs, or duplicate full offsets — inf, never accepted)
                    trials = []
                    for c in tail:
                        t = None if c in offs else \
                            sorted(offs[:pos] + [c] + offs[pos + 1 :])
                        if t is not None:
                            fo = full_offsets(t)
                            if len(set(fo)) != len(fo):
                                t = None
                        trials.append(t)
                    batch = [full_offsets(t) for t in trials if t is not None]
                    vals = (torch_circulant.profile_batch(n, batch, dev)
                            if engine == "torch" else
                            (_circulant_profile(n, offs) for offs in batch))
                    adv = len(tail)
                    for j, trial in enumerate(trials):
                        it += 1
                        if trial is None:
                            continue
                        val = next(vals)
                        if val < cur:
                            offs, cur = trial, val
                            improved = True
                            adv = j + 1
                            break
                    i += adv
            if cur < best:
                best, best_offs = cur, list(offs)
                history.append(best[0])
        if cur < best:
            best, best_offs = cur, list(offs)
            history.append(best[0])
    offs = full_offsets(best_offs or [])
    g = circulant(n, offs, f"({n},{k})-Suboptimal")
    return SearchResult(
        graph=g,
        mpl=best[0],
        diameter=best[1],
        mpl_lb=metrics.mpl_lower_bound(n, k),
        d_lb=metrics.diameter_lower_bound(n, k),
        iterations=it,
        accepted=it,
        history=history,
        offsets=tuple(offs),
    )


# --------------------------------------------------------------------------------
# Orbit moves
# --------------------------------------------------------------------------------

def _orbit(n: int, s: int, u: int, v: int) -> frozenset[tuple[int, int]]:
    """Edge orbit of (u,v) under rotation by s (n/s-fold symmetry)."""
    out = set()
    t = 0
    while t < n:
        a, b = (u + t) % n, (v + t) % n
        out.add((min(a, b), max(a, b)))
        t += s
    return frozenset(out)


# compound-move gate: moves_per_step > 1 arms multi-orbit proposals once the
# single-move accept rate over a _COMPOUND_WINDOW-proposal window drops
# below _COMPOUND_RATE (the near-convergence collapse)
_COMPOUND_WINDOW = 50
_COMPOUND_RATE = 0.05


def _draw_orbit_swap(rng, work_list, work_chords, ring_edges, n, s, fold):
    """Draw one 2-orbit swap against ``(work_list, work_chords)``.

    Returns ``(i1, i2, no1, no2, new_edges, remaining)`` or None for an
    invalid draw.  Consumes the PRNG exactly like the classic inline
    single-move proposal, so the ``moves_per_step=1`` trajectory is
    bit-identical to the historical one.
    """
    i1, i2 = rng.choice(len(work_list), size=2, replace=False)
    o1, o2 = work_list[i1], work_list[i2]
    (u1, v1) = next(iter(o1))
    (u2, v2) = next(iter(o2))
    # orbit-level swap with a random relative rotation of the second orbit
    tshift = int(rng.integers(fold)) * s
    if rng.integers(2):
        na, nb = (u1, (v2 + tshift) % n), ((u2 + tshift) % n, v1)
    else:
        na, nb = (u1, (u2 + tshift) % n), (v1, (v2 + tshift) % n)
    if na[0] == na[1] or nb[0] == nb[1]:
        return None
    no1, no2 = _orbit(n, s, *na), _orbit(n, s, *nb)
    # orbit sizes must be conserved so degrees are conserved
    if len(no1) + len(no2) != len(o1) + len(o2):
        return None
    remaining = work_chords - set(o1) - set(o2)
    new_edges = set(no1) | set(no2)
    if len(new_edges) != len(no1) + len(no2):
        return None
    if new_edges & (remaining | ring_edges):
        return None
    return int(i1), int(i2), no1, no2, new_edges, remaining


def _symmetric_random_start(
    n: int, k: int, s: int, rng: np.random.Generator, max_tries: int = 4000
) -> set[frozenset[tuple[int, int]]] | None:
    """Random set of chord orbits making ring+chords k-regular, symmetric
    under rotation by s.  Returns the set of orbits or None."""
    for _ in range(max_tries):
        deg = np.full(n, 2)  # ring
        orbits: set[frozenset[tuple[int, int]]] = set()
        used: set[tuple[int, int]] = {(i, (i + 1) % n) for i in range(n - 1)} | {(0, n - 1)}
        fail = False
        guard = 0
        while (deg < k).any():
            guard += 1
            if guard > 50 * n:
                fail = True
                break
            us = np.where(deg < k)[0]
            u = int(rng.choice(us))
            v = int(rng.integers(n))
            if v == u:
                continue
            orb = _orbit(n, s, u, v)
            if any(e in used for e in orb):
                continue
            # degree increment per vertex from this orbit
            dd = np.zeros(n, dtype=np.int64)
            for a, b in orb:
                dd[a] += 1
                dd[b] += 1
            if ((deg + dd) > k).any():
                continue
            orbits.add(orb)
            used |= set(orb)
            deg += dd
        if not fail and (deg == k).all():
            return orbits
    return None


def _circulant_orbits(n: int, s: int, offsets) -> set[frozenset[tuple[int, int]]]:
    """Chord-edge orbits (under rotation by s) of circulant C_n(offsets).

    Excludes the ring offset 1 — a circulant is invariant under every
    rotation, so its chords decompose into orbits of the coarser rotation-by-s
    subgroup, giving ``symmetric_sa_search`` a warm start.
    """
    orbits: set[frozenset[tuple[int, int]]] = set()
    for o in sorted({x % n for x in offsets} - {0}):
        if o in (1, n - 1):
            continue
        for u in range(s):
            orbits.add(_orbit(n, s, u, (u + o) % n))
    return orbits


# --------------------------------------------------------------------------------
# Single-chain orbit polish
# --------------------------------------------------------------------------------

def _mpl_fast(adj: np.ndarray, n_sources: int | None = None) -> tuple[float, float]:
    """(MPL, diameter) from a boolean adjacency matrix via frontier BFS.

    Uses float32 matmuls (BLAS) for the frontier expansion.  If ``n_sources``
    is given, BFS runs only from vertices ``0..n_sources-1`` — valid for
    graphs whose automorphism group acts with those vertices as orbit
    representatives (e.g. rotationally symmetric graphs with period
    ``n_sources``); MPL/diameter over those rows equal the global values.
    """
    n = adj.shape[0]
    s = n_sources or n
    a32 = adj.astype(np.float32)
    reach = np.zeros((s, n), dtype=bool)
    reach[np.arange(s), np.arange(s)] = True
    frontier = reach.astype(np.float32)
    total = 0.0
    d = 0
    while True:
        nxt = (frontier @ a32) > 0
        frontier_b = nxt & ~reach
        if not frontier_b.any():
            break
        d += 1
        total += d * frontier_b.sum()
        reach |= frontier_b
        frontier = frontier_b.astype(np.float32)
    if not reach.all():
        return float("inf"), float("inf")
    return total / (s * (n - 1)), float(d)


def symmetric_sa_search(
    n: int,
    k: int,
    seed: int = 0,
    n_iter: int = 3000,
    fold: int = 4,
    t_start: float = 0.05,
    t_end: float = 1e-4,
    target_mpl: float | None = None,
    start_orbits: set[frozenset[tuple[int, int]]] | None = None,
    start_offsets: tuple[int, ...] | None = None,
    incremental: bool = True,
    moves_per_step: int = 1,
    device=None,
) -> SearchResult:
    """SA over *orbit-level* edge swaps of graphs with ``fold``-fold
    rotational symmetry (paper: 'random iteration of Hamiltonian graphs with
    rotational symmetry', used for the 252/256/264-vertex graphs).

    The graph stays invariant under rotation by s = n/fold throughout, so the
    search space shrinks by ~fold× and every accepted design is symmetric.
    ``start_offsets`` (a circulant offset list, e.g. from
    ``known_optimal.KNOWN_CIRCULANT_OFFSETS``) warm-starts the walk from that
    circulant's chord orbits; ``start_orbits`` passes an explicit orbit set
    instead (mutually exclusive).

    With ``incremental=True`` (the default) proposals are priced by
    ``metrics.SymmetricAPSP`` on ``device`` — distances delta-updated from
    only the ``n/fold`` representative sources, batched over the whole orbit
    swap, through the BFS sweep and min-plus patch kernels.
    ``incremental=False`` keeps the dense host pricing (``_mpl_fast`` from
    ``s`` sources per proposal); both paths consume the PRNG identically and
    the evaluator is exact, so the two trajectories are bit-identical per
    seed.  ``device``: ``None`` is the CUDA device (raises without one),
    ``"cpu"`` runs the kernels' plain versions; the reference's ``engine=``
    has no counterpart.

    ``moves_per_step > 1`` arms compound proposals: once the single-move
    accept rate collapses near convergence (below ``_COMPOUND_RATE`` over a
    ``_COMPOUND_WINDOW``-proposal window), each step samples up to
    ``moves_per_step`` 2-orbit swaps against a working copy of the orbit
    set and prices the merged multi-orbit change in one batched
    ``evaluate_swap``.  The default (1) leaves the classic trajectory
    untouched; compound steps consume extra PRNG draws only after the rate
    gate opens, so runs remain bit-reproducible per seed.
    """
    dev = resolve_device(device)
    if moves_per_step < 1:
        raise ValueError(f"moves_per_step={moves_per_step} must be >= 1")
    fold_i = int(fold)
    if fold_i != fold or fold_i < 1 or n % fold_i:
        raise ValueError(
            f"fold={fold!r} must be a positive integer divisor of n={n}: a "
            "non-divisor fold would make the rotation orbits irregular")
    fold = fold_i
    s = n // fold
    if start_offsets is not None:
        if start_orbits is not None:
            raise ValueError("pass either start_orbits or start_offsets, not both")
        start_orbits = _circulant_orbits(n, s, start_offsets)
    rng = np.random.default_rng(seed)
    orbits = set(start_orbits) if start_orbits is not None else \
        _symmetric_random_start(n, k, s, rng)
    if orbits is None:
        raise RuntimeError(f"no symmetric start found for ({n},{k}) fold={fold}")
    ring_edges = {(i, (i + 1) % n) for i in range(n - 1)} | {(0, n - 1)}

    def adj_of(orbs) -> np.ndarray:
        a = np.zeros((n, n), dtype=bool)
        for i, j in ring_edges:
            a[i, j] = a[j, i] = True
        for orb in orbs:
            for i, j in orb:
                a[i, j] = a[j, i] = True
        return a

    gamma = math.exp(math.log(t_end / t_start) / n_iter)
    adj = adj_of(orbits)
    ev = metrics.SymmetricAPSP(adj, shift=s, device=dev) if incremental else None
    if ev is not None:
        cur_mpl, cur_d = ev.mpl(), ev.diameter()
    else:
        cur_mpl, cur_d = _mpl_fast(adj, n_sources=s)
    best_orbits, best_mpl, best_d = set(orbits), cur_mpl, cur_d
    lb = metrics.mpl_lower_bound(n, k)
    tgt = target_mpl if target_mpl is not None else lb
    t = t_start
    accepted = 0
    history = [best_mpl]
    orb_list = list(orbits)
    # incremental chord-edge set (excludes ring edges)
    chord_edges: set[tuple[int, int]] = set()
    for orb in orb_list:
        chord_edges |= set(orb)

    win_n = win_acc = 0
    compound_on = False
    compound_steps = 0
    for _ in range(n_iter):
        t *= gamma
        if len(orb_list) < 2:
            break
        # draw up to nmoves 2-orbit swaps against a working copy of the
        # orbit state; nmoves == 1 reproduces the classic proposal exactly
        nmoves = moves_per_step if compound_on else 1
        work_list, work_chords = orb_list, chord_edges
        got = 0
        for _m in range(nmoves):
            if len(work_list) < 2:
                break
            mv = _draw_orbit_swap(rng, work_list, work_chords, ring_edges,
                                  n, s, fold)
            if mv is None:
                continue
            i1, i2, no1, no2, new_edges, remaining = mv
            work_list = [o for idx, o in enumerate(work_list)
                         if idx not in (i1, i2)] + [no1, no2]
            work_chords = remaining | new_edges
            got += 1
        if got == 0:
            continue
        if got > 1:
            compound_steps += 1
        # edges in both states are removed-then-re-added: cancel them (set
        # differences of orbit-closed sets stay orbit-closed)
        removed = sorted(chord_edges - work_chords)
        added = sorted(work_chords - chord_edges)
        if ev is not None:
            tok = ev.evaluate_swap(removed, added)
            new_mpl = tok.mpl
            new_d = float(tok.diam) if tok.diam < n else float("inf")
        else:
            # mutate adjacency in place on a copy restricted to changed entries
            a2 = adj.copy()
            for i, j in removed:
                a2[i, j] = a2[j, i] = False
            for i, j in added:
                a2[i, j] = a2[j, i] = True
            new_mpl, new_d = _mpl_fast(a2, n_sources=s)
        win_n += 1
        dm = new_mpl - cur_mpl
        if dm < 0 or rng.random() < math.exp(-dm / max(t, 1e-12)):
            orb_list, cur_mpl, cur_d = work_list, new_mpl, new_d
            chord_edges = work_chords
            if ev is not None:
                ev.commit(tok)
            else:
                adj = a2
            accepted += 1
            win_acc += 1
            if (cur_mpl, cur_d) < (best_mpl, best_d):
                best_orbits, best_mpl, best_d = set(orb_list), cur_mpl, cur_d
                history.append(best_mpl)
                if best_mpl <= tgt + 1e-9:
                    break
        if moves_per_step > 1 and win_n >= _COMPOUND_WINDOW:
            # the gate is adaptive both ways: compound moves arm when the
            # single-move accept rate collapses and disarm if it recovers
            compound_on = win_acc < _COMPOUND_RATE * win_n
            win_n = win_acc = 0

    edges = set(ring_edges)
    for orb in best_orbits:
        edges |= set(orb)
    g = from_edges(n, edges, f"({n},{k})-Suboptimal")
    return SearchResult(
        graph=g,
        mpl=best_mpl,
        diameter=best_d,
        mpl_lb=lb,
        d_lb=metrics.diameter_lower_bound(n, k),
        iterations=n_iter,
        accepted=accepted,
        history=history,
        evals_delta=ev.n_delta if ev is not None else 0,
        evals_full=ev.n_full if ev is not None else 0,
        compound_steps=compound_steps,
    )


# --------------------------------------------------------------------------------
# Device-priced replica polish
# --------------------------------------------------------------------------------

class _PolishChain:
    """One replica of the device-priced orbit polish: host-side orbit state
    plus the padded neighbour table the device sweep prices from.  Under
    delta pricing the chain also holds its representative-row distance
    state twice: ``dist`` on the host, which the batched lost-parent removal
    test reads, and ``dist_t``, the same rows on the device, which the next
    dispatch merges into; ``best_dist``/``best_dist_t`` are the snapshot
    replica exchange restores from.  Both are rebound, never mutated in
    place, so snapshots are safe by reference."""

    __slots__ = ("rng", "orb_list", "chord_edges", "adj", "nbr",
                 "cur_mpl", "cur_d", "best_orbits", "best_mpl", "best_d", "t",
                 "dist", "best_dist", "dist_t", "best_dist_t")

    def __init__(self, rng, orb_list, adj, t_start):
        self.rng = rng
        self.orb_list = list(orb_list)
        self.chord_edges = {e for orb in orb_list for e in orb}
        self.adj = adj
        self.nbr = metrics._nbr_table(adj)
        self.t = t_start
        self.cur_mpl = self.cur_d = float("inf")
        self.best_orbits = set(self.orb_list)
        self.best_mpl = self.best_d = float("inf")
        self.dist = self.best_dist = None
        self.dist_t = self.best_dist_t = None

    def set_dist(self, dist_t: torch.Tensor) -> None:
        """Adopt ``dist_t`` (s, n) as the current rows, device and host."""
        self.dist_t = dist_t
        self.dist = dist_t.cpu().numpy()

    def trial_nbr(self, removed, added) -> np.ndarray:
        """Neighbour table of the proposal graph (degrees are conserved by
        the orbit-size check, so kmax never grows)."""
        for u, v in removed:
            self.adj[u, v] = self.adj[v, u] = False
        for u, v in added:
            self.adj[u, v] = self.adj[v, u] = True
        try:
            out = self.nbr.copy()
            for u in sorted({x for e in (*removed, *added) for x in e}):
                ws = np.nonzero(self.adj[u])[0]
                out[u, :] = -1
                out[u, : len(ws)] = ws
            return out
        finally:
            for u, v in added:
                self.adj[u, v] = self.adj[v, u] = False
            for u, v in removed:
                self.adj[u, v] = self.adj[v, u] = True

    def commit(self, removed, added, work_list, work_chords, nbr, mpl, d):
        for u, v in removed:
            self.adj[u, v] = self.adj[v, u] = False
        for u, v in added:
            self.adj[u, v] = self.adj[v, u] = True
        self.nbr = nbr
        self.orb_list, self.chord_edges = work_list, work_chords
        self.cur_mpl, self.cur_d = mpl, d


def _resync_check(chains, s: int, n: int) -> None:
    """Drift guard for the delta-priced polish: re-sweep every chain's
    current graph from scratch in one dispatch, on the device its rows live
    on, and assert that both copies of the maintained incremental state
    match it bit for bit.  Raises ``AssertionError`` on any divergence."""
    base = torch.stack([ch.dist_t for ch in chains])
    nbrs = np.stack([ch.nbr for ch in chains]).astype(np.int32, copy=False)
    _, _, state = cuda_sweep.sharded_delta_state(
        base, nbrs, [np.arange(s)] * len(chains), [None] * len(chains), n,
        device=base.device)
    for r, ch in enumerate(chains):
        if not (torch.equal(state[r], ch.dist_t)
                and np.array_equal(state[r].cpu().numpy(), ch.dist)):
            raise AssertionError(
                f"delta pricing drift: replica {r} incremental distance "
                f"state diverged from the full re-sweep")


def _replica_polish(
    n: int,
    k: int,
    seed: int,
    n_iter: int,
    fold: int,
    start_orbits,
    replicas: int,
    exchange_every: int = 50,
    t_start: float = 0.05,
    t_end: float = 1e-4,
    delta: bool = True,
    proposal_batch: int = 1,
    resync_every: int = 64,
    full_rebuild_frac: float = 0.9,
    device=None,
) -> SearchResult:
    """Parallel-replica orbit polish with device-batched pricing.

    ``replicas`` lockstep annealing chains share the circulant warm start,
    each on its own PRNG stream (``[seed, r]``, replica 0 protected).  Every
    iteration each chain draws ``proposal_batch`` orbit swaps; all R*M
    proposals are priced in one dispatch and only per-proposal (total, max)
    scalars come home.

    With ``delta=True`` (default) the dispatch is ``sharded_delta_state``:
    the host batched lost-parent test marks the rows a removal touches, the
    device re-sweeps only those rows on the post-removal graph and min-plus
    patches the added edges back in.  Proposals whose affected set exceeds
    ``full_rebuild_frac`` of the rows (or whose base is disconnected) fall
    back to a full re-sweep expressed in the same vocabulary.  Every
    ``resync_every`` iterations (and at the end) ``_resync_check`` asserts
    the incremental state has not drifted.  ``delta=False`` re-sweeps every
    proposal (``sharded_rows_totals``); the trajectory is the same.

    Batched proposals are accepted greedily in lockstep order: once a chain
    accepts, the rest of its batch is discarded and consumes no RNG.  Every
    ``exchange_every`` iterations the globally best state replaces the
    worst non-protected chain.
    """
    if proposal_batch < 1:
        raise ValueError(f"proposal_batch must be >= 1, got {proposal_batch}")
    dev = resolve_device(device)
    s = n // fold
    gamma = math.exp(math.log(t_end / t_start) / n_iter)
    ring_edges = {(i, (i + 1) % n) for i in range(n - 1)} | {(0, n - 1)}

    def adj_of(orbs) -> np.ndarray:
        a = np.zeros((n, n), dtype=bool)
        for i, j in ring_edges:
            a[i, j] = a[j, i] = True
        for orb in orbs:
            for i, j in orb:
                a[i, j] = a[j, i] = True
        return a

    start = sorted(start_orbits, key=sorted)
    chains = [_PolishChain(np.random.default_rng([seed, r]), start,
                           adj_of(start), t_start)
              for r in range(replicas)]
    norm = s * (n - 1)
    dispatches = 1
    # all chains share the warm start: one pricing seeds cur/best
    if delta:
        tot0, mx0, st0 = cuda_sweep.sharded_delta_state(
            torch.zeros((1, s, n), dtype=torch.int32, device=dev),
            np.stack([chains[0].nbr]), [np.arange(s)], [None], n, device=dev)
        for ch in chains:
            ch.set_dist(st0[0])
            ch.best_dist, ch.best_dist_t = ch.dist, ch.dist_t
    else:
        tot0, mx0 = cuda_sweep.sharded_rows_totals(
            np.stack([chains[0].nbr]), s, n, device=dev)
    mpl0 = tot0[0] / norm if mx0[0] < n else float("inf")
    d0 = float(mx0[0]) if mx0[0] < n else float("inf")
    for ch in chains:
        ch.cur_mpl = ch.best_mpl = mpl0
        ch.cur_d = ch.best_d = d0

    mprop = proposal_batch
    bsz = replicas * mprop
    accepted = 0
    evals_delta = evals_full = 0
    history = [mpl0]
    global_best = (mpl0, d0)
    nbr_stack = np.empty((bsz,) + chains[0].nbr.shape, dtype=np.int32)
    empty = np.empty(0, dtype=np.int64)
    for it in range(n_iter):
        proposals: list = [None] * bsz
        srcs: list = [empty] * bsz
        patches: list = [None] * bsz
        for r, ch in enumerate(chains):
            ch.t *= gamma
            for m in range(mprop):
                slot = r * mprop + m
                nbr_stack[slot] = ch.nbr  # idle slots price the unchanged graph
                if len(ch.orb_list) < 2:
                    continue
                mv = _draw_orbit_swap(ch.rng, ch.orb_list, ch.chord_edges,
                                      ring_edges, n, s, fold)
                if mv is None:
                    continue
                i1, i2, no1, no2, new_edges, remaining = mv
                work_list = [o for idx, o in enumerate(ch.orb_list)
                             if idx not in (i1, i2)] + [no1, no2]
                work_chords = remaining | new_edges
                removed = sorted(ch.chord_edges - work_chords)
                added = sorted(work_chords - ch.chord_edges)
                if delta:
                    aff = metrics._removal_affected_nbr(ch.dist, ch.nbr,
                                                        removed)
                    full = (ch.cur_d == float("inf")
                            or int(aff.sum()) > full_rebuild_frac * s)
                    if full:
                        nbr_stack[slot] = ch.trial_nbr(removed, added)
                        srcs[slot] = np.arange(s)
                        evals_full += 1
                    else:
                        # re-sweep only the affected rows on the post-removal
                        # graph; the added edges come back as a min-plus patch
                        nbr_stack[slot] = ch.trial_nbr(removed, ())
                        srcs[slot] = np.nonzero(aff)[0]
                        patches[slot] = added
                        evals_delta += 1
                    proposals[slot] = (removed, added, work_list, work_chords,
                                       None)
                else:
                    nbr_stack[slot] = tn = ch.trial_nbr(removed, added)
                    evals_full += 1
                    proposals[slot] = (removed, added, work_list, work_chords,
                                       tn)
        if any(p is not None for p in proposals):
            if delta:
                totals, maxima, states = cuda_sweep.sharded_delta_state(
                    torch.stack([ch.dist_t for ch in chains]), nbr_stack, srcs,
                    patches, n, device=dev)
            else:
                totals, maxima = cuda_sweep.sharded_rows_totals(
                    nbr_stack, s, n, device=dev)
                states = None
            dispatches += 1
            for r, ch in enumerate(chains):
                committed = False
                for m in range(mprop):
                    slot = r * mprop + m
                    if proposals[slot] is None or committed:
                        continue  # discarded batch slots consume no RNG
                    new_mpl = (totals[slot] / norm if maxima[slot] < n
                               else float("inf"))
                    new_d = (float(maxima[slot]) if maxima[slot] < n
                             else float("inf"))
                    dm = new_mpl - ch.cur_mpl
                    if not (dm < 0
                            or ch.rng.random() < math.exp(-dm / max(ch.t, 1e-12))):
                        continue
                    removed, added, work_list, work_chords, tn = proposals[slot]
                    if tn is None:  # delta slots carry the post-removal table
                        tn = ch.trial_nbr(removed, added)
                    ch.commit(removed, added, work_list, work_chords, tn,
                              new_mpl, new_d)
                    if delta:
                        # only the accepted slot's rows leave the batch (a
                        # clone, so the batch itself can be freed)
                        ch.set_dist(states[slot].clone())
                    committed = True
                    accepted += 1
                    if (ch.cur_mpl, ch.cur_d) < (ch.best_mpl, ch.best_d):
                        ch.best_orbits = set(ch.orb_list)
                        ch.best_mpl, ch.best_d = ch.cur_mpl, ch.cur_d
                        if delta:
                            ch.best_dist, ch.best_dist_t = ch.dist, ch.dist_t
                        if (ch.best_mpl, ch.best_d) < global_best:
                            global_best = (ch.best_mpl, ch.best_d)
                            history.append(ch.best_mpl)
            states = None
            if replicas > 1 and (it + 1) % exchange_every == 0 and it + 1 < n_iter:
                gb = min(range(replicas),
                         key=lambda r: (chains[r].best_mpl, chains[r].best_d, r))
                worst = max(range(1, replicas),
                            key=lambda r: (chains[r].cur_mpl, chains[r].cur_d, -r))
                if (chains[gb].best_mpl, chains[gb].best_d) < \
                        (chains[worst].cur_mpl, chains[worst].cur_d):
                    ch = chains[worst]
                    ch.orb_list = sorted(chains[gb].best_orbits, key=sorted)
                    ch.chord_edges = {e for orb in ch.orb_list for e in orb}
                    ch.adj = adj_of(ch.orb_list)
                    ch.nbr = metrics._nbr_table(ch.adj)
                    ch.cur_mpl, ch.cur_d = chains[gb].best_mpl, chains[gb].best_d
                    if delta:
                        ch.dist = chains[gb].best_dist
                        ch.dist_t = chains[gb].best_dist_t
        if delta and (it + 1 == n_iter
                      or (resync_every and (it + 1) % resync_every == 0)):
            _resync_check(chains, s, n)
            dispatches += 1

    gb = min(range(replicas),
             key=lambda r: (chains[r].best_mpl, chains[r].best_d, r))
    best = chains[gb]
    edges = set(ring_edges)
    for orb in best.best_orbits:
        edges |= set(orb)
    g = from_edges(n, edges, f"({n},{k})-Suboptimal")
    return SearchResult(
        graph=g,
        mpl=best.best_mpl,
        diameter=best.best_d,
        mpl_lb=metrics.mpl_lower_bound(n, k),
        d_lb=metrics.diameter_lower_bound(n, k),
        iterations=n_iter,
        accepted=accepted,
        history=history,
        replicas=replicas,
        evals_delta=evals_delta,
        evals_full=evals_full,
        device_dispatches=dispatches,
    )


# --------------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------------

def large_search(
    n: int,
    k: int,
    seed: int = 0,
    budget: int | None = None,
    fold: int = 4,
    polish: bool = True,
    replicas: int = 1,
    exchange_every: int = 50,
    delta: bool = True,
    proposal_batch: int = 1,
    resync_every: int = 64,
    polish_iters: int | None = None,
    device=None,
) -> SearchResult:
    """Large-N tier: circulant warm start, then an orbit-level polish
    warm-started from it (when ``fold`` divides ``n``).

    Returns whichever of the two stages found the lower (MPL, diameter).  A
    pinned offset set in ``KNOWN_CIRCULANT_OFFSETS`` skips the hillclimb
    (seed 0 only); otherwise ``circulant_search`` runs ``budget`` (or 400)
    iterations, pricing on the device at n >= 4096.  The polish runs
    ``polish_iters`` iterations, or ``max(200, 2 * budget)``.  With
    ``replicas=1`` (the default) it is ``symmetric_sa_search``, one chain
    priced by ``metrics.SymmetricAPSP``; ``replicas >= 2`` runs the replica
    polish (``_replica_polish``: ``exchange_every``, ``delta``,
    ``proposal_batch`` and ``resync_every`` apply to it only).

    ``device`` is where both stages price: ``None`` is the CUDA device (and
    raises without one), ``"cpu"`` runs the kernels' plain versions.  The
    reference's ``engine=`` has no counterpart.  Errors in the polish
    propagate; the reference instead returns the unpolished circulant on a
    RuntimeError or ValueError.
    """
    dev = resolve_device(device)
    pinned = KNOWN_CIRCULANT_OFFSETS.get((n, k)) if seed == 0 else None
    if pinned is not None:
        mpl_c, d_c = _circulant_profile(n, pinned)
        res_c = SearchResult(
            graph=circulant(n, pinned, f"({n},{k})-Suboptimal"),
            mpl=mpl_c, diameter=d_c,
            mpl_lb=metrics.mpl_lower_bound(n, k),
            d_lb=metrics.diameter_lower_bound(n, k),
            iterations=0, accepted=0, history=[mpl_c], offsets=tuple(pinned))
    else:
        res_c = circulant_search(n, k, seed=seed, n_iter=budget or 400, device=dev)
    if not polish or n % fold or res_c.offsets is None:
        return res_c
    n_polish = (polish_iters if polish_iters is not None
                else max(200, (budget or 400) * 2))
    orbits = _circulant_orbits(n, n // fold, res_c.offsets)
    if replicas > 1:
        res_s = _replica_polish(
            n, k, seed=seed, n_iter=n_polish, fold=fold, start_orbits=orbits,
            replicas=replicas, exchange_every=exchange_every, delta=delta,
            proposal_batch=proposal_batch, resync_every=resync_every, device=dev)
    else:
        res_s = symmetric_sa_search(
            n, k, seed=seed, n_iter=n_polish, fold=fold, start_orbits=orbits,
            device=dev)
    return res_s if (res_s.mpl, res_s.diameter) < (res_c.mpl, res_c.diameter) else res_c
