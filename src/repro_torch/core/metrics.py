"""Graph invariants and the incremental evaluators of the search (the
counterpart of ``repro.core.metrics``).

On the device: ``apsp_hops`` (all-pairs hop distances, every source swept
at once by ``bfs_sweep_kernel`` through ``bfs_sweep.bfs_rows``) and ``apsp``
built on it, hence ``is_connected``, ``mpl``, ``eccentricities``,
``diameter`` and ``stats`` when they are given no ``dist``; and
``SymmetricAPSP``, whose distance rows live on the device.  ``device=None``
is the CUDA device (raises without one); ``"cpu"`` runs the kernel's plain
PyTorch version.

On the host, numpy copies of the reference's, unchanged: ``_nbr_table``,
``_parent_counts``, ``_parent_count_cols``, ``_removal_affected``,
``_removal_affected_nbr``, ``_bfs_rows``, ``IncrementalAPSP`` (the dense
evaluator of ``sa_search``, its numpy path: the reference's C fast path has
no counterpart), ``girth``, ``bisection_width`` (Kernighan–Lin from the
reference's seeded starts), ``edge_betweenness_proxy`` and the Cerf et al.
lower bounds.  The batched lost-parent removal test runs on the host,
against each replica chain's mirrored distance rows and against the columns
``SymmetricAPSP`` pulls from its device state, exactly as in the reference.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import bfs_sweep
from .engines.cuda_sweep import _check_int32_sums
from .graphs import Graph

__all__ = [
    "apsp",
    "apsp_hops",
    "IncrementalAPSP",
    "SwapToken",
    "SymmetricAPSP",
    "mpl",
    "diameter",
    "eccentricities",
    "girth",
    "is_connected",
    "bisection_width",
    "moore_bound_vertices",
    "diameter_lower_bound",
    "mpl_lower_bound",
    "edge_betweenness_proxy",
    "GraphStats",
    "stats",
]


def apsp_hops(adj: np.ndarray, sentinel: int | None = None, device=None) -> np.ndarray:
    """All-pairs hop distances from a boolean adjacency as an int32 numpy
    array, ``sentinel`` (default n, one more than any real distance) where
    unreachable.  Every source is swept at once on ``device``:
    ``bfs_sweep_kernel`` on a CUDA device, its plain version on the CPU.

    The kernel keeps two frontier buffers of n words in shared memory, so
    n is at most ``bfs_sweep.MAX_SWEEP_N`` (29056); a larger graph is
    refused on every device, where the reference's host BFS answers.  The
    (n, n) int32 result is n**2 * 4 bytes on the device and again at home
    (3.4 GB at the limit)."""
    n = adj.shape[0]
    if n > bfs_sweep.MAX_SWEEP_N:
        raise ValueError(f"apsp_hops sweeps every source in one bfs_sweep_kernel "
                         f"launch: n={n} is above MAX_SWEEP_N={bfs_sweep.MAX_SWEEP_N}")
    return bfs_sweep.bfs_rows(_nbr_table(adj), np.arange(n),
                              sentinel if sentinel is not None else n, device=device)


def apsp(g: Graph, device=None) -> np.ndarray:
    """All-pairs shortest-path hop distances. inf for disconnected pairs."""
    hops = apsp_hops(g.adjacency(), device=device)
    dist = hops.astype(float)
    dist[hops >= g.n] = np.inf
    return dist


def is_connected(g: Graph, dist: np.ndarray | None = None, device=None) -> bool:
    d = apsp(g, device) if dist is None else dist
    return bool(np.isfinite(d).all())


def _nbr_table(adj: np.ndarray, kmax: int | None = None) -> np.ndarray:
    """Padded (n, kmax) neighbour table (pad -1) from a boolean adjacency."""
    n = adj.shape[0]
    deg = adj.sum(1)
    kmax = kmax or max(1, int(deg.max()))
    nbr = np.full((n, kmax), -1, dtype=np.int32)
    for u in range(n):
        ws = np.nonzero(adj[u])[0]
        nbr[u, : len(ws)] = ws
    return nbr


def _refresh_nbr_rows(adj: np.ndarray, nbr: np.ndarray, verts) -> np.ndarray:
    """``nbr`` with the rows of ``verts`` rewritten from ``adj`` in place,
    or a wider table rebuilt when a row no longer fits."""
    for u in sorted(set(verts)):
        ws = np.nonzero(adj[u])[0]
        if len(ws) > nbr.shape[1]:
            return _nbr_table(adj, int(adj.sum(1).max()))
        nbr[u, :] = -1
        nbr[u, : len(ws)] = ws
    return nbr


def _parent_counts(adj: np.ndarray, dist: np.ndarray, nbr: np.ndarray | None = None) -> np.ndarray:
    """npar[s, x] = number of BFS-DAG parents of x w.r.t. source s.

    A neighbour w of x is a parent when dist[s, w] + 1 == dist[s, x].  Used
    for the exact edge-removal test: deleting a set of edges changes
    distances from s iff some vertex loses *all* of its parent edges.
    ``dist`` may be row-restricted (shape (n_sources, n)); the counts are
    returned with the same shape.  Passing the maintained ``nbr`` table
    avoids rebuilding it (the counts come from a vectorized gather over it).
    """
    if nbr is None:
        nbr = _nbr_table(adj)
    valid = nbr >= 0
    nb = np.where(valid, nbr, 0)
    # chunk over source rows so the (rows, n, kmax) gather temp stays ~64 MB
    # regardless of n (at N=8192 the unchunked temp is 268 MB per call)
    out = np.empty(dist.shape, dtype=np.int16)
    step = max(1, (1 << 24) // max(1, dist.shape[1] * nbr.shape[1]))
    for lo in range(0, dist.shape[0], step):
        d = dist[lo : lo + step]
        out[lo : lo + step] = (((d[:, nb] + np.int32(1)) == d[:, :, None])
                               & valid[None, :, :]).sum(-1, dtype=np.int16)
    return out


def _removal_affected(dist: np.ndarray, npar: np.ndarray, removed) -> np.ndarray:
    """Boolean mask over the source rows of ``dist``: rows whose distances
    change when the ``removed`` edges are all deleted simultaneously.

    Exact batched test: per source, count how many removed edges are BFS-DAG
    parent edges of each endpoint vertex; the row is affected iff some vertex
    loses every parent it had (count == npar).  If an endpoint keeps a
    parent, every vertex keeps a parent (induction on hop distance) and all
    old distances stay achievable.  For vertex-disjoint removals this reduces
    to the classic sole-parent test (npar == 1).
    """
    return _lost_parent_mask(dist, removed, lambda x: npar[:, x])


def _lost_parent_mask(dist: np.ndarray, removed, parents) -> np.ndarray:
    """The rows of ``dist`` in which some endpoint of the ``removed`` edges
    loses every BFS-DAG parent it had; ``parents(x)`` is the column of
    parent counts of vertex x over those rows."""
    aff = np.zeros(dist.shape[0], dtype=bool)
    lost: dict[int, np.ndarray] = {}
    for a, b in removed:
        da, db = dist[:, a], dist[:, b]
        pa_of_b = (da + 1 == db).astype(np.int16)
        pa_of_a = (db + 1 == da).astype(np.int16)
        lost[b] = pa_of_b if b not in lost else lost[b] + pa_of_b
        lost[a] = pa_of_a if a not in lost else lost[a] + pa_of_a
    for x, cnt in lost.items():
        aff |= (cnt > 0) & (cnt == parents(x))
    return aff


def _parent_count_cols(dist: np.ndarray, nbr: np.ndarray, cols) -> np.ndarray:
    """``_parent_counts`` restricted to the vertex columns ``cols``:
    (rows, len(cols)) int16 from an O(rows x len(cols) x kmax) gather, so
    callers that only probe a few columns (the removal test probes the
    removed edges' endpoints) need not maintain the full (rows, n) table."""
    cols = np.asarray(cols, dtype=np.int64)
    nb = nbr[cols]
    valid = nb >= 0
    nbx = np.where(valid, nb, 0)
    return (((dist[:, nbx] + np.int32(1)) == dist[:, cols][:, :, None])
            & valid[None, :, :]).sum(-1, dtype=np.int16)


def _removal_affected_nbr(dist: np.ndarray, nbr: np.ndarray, removed) -> np.ndarray:
    """``_removal_affected`` with the parent counts gathered on demand from
    the neighbour table instead of a maintained (rows, n) count table — the
    counts are only ever read at the removed edges' endpoint columns, so the
    host-side test of the device delta tier stays O(rows x endpoints x kmax)
    per proposal."""
    pts = sorted({x for e in removed for x in e})
    idx = {p: i for i, p in enumerate(pts)}
    npc = _parent_count_cols(dist, nbr, pts)
    return _lost_parent_mask(dist, removed, lambda x: npc[:, idx[x]])



def moore_bound_vertices(k: int, d: int) -> int:
    """Max vertices within distance d of any vertex in a k-regular graph."""
    if d == 0:
        return 1
    total = 1
    shell = k
    for _ in range(1, d + 1):
        total += shell
        shell *= k - 1
    return total


def diameter_lower_bound(n: int, k: int) -> int:
    d = 0
    while moore_bound_vertices(k, d) < n:
        d += 1
    return d


def mpl_lower_bound(n: int, k: int) -> float:
    """Cerf et al. (1974) lower bound on MPL of an (n,k) regular graph.

    From any root, at most k(k-1)^(i-1) vertices can sit at distance i; pack
    the other n-1 vertices greedily into the nearest shells.
    """
    remaining = n - 1
    i = 1
    shell = k
    ssum = 0.0
    while remaining > 0:
        take = min(shell, remaining)
        ssum += i * take
        remaining -= take
        shell *= k - 1
        i += 1
    return ssum / (n - 1)


def _bfs_rows(a32: np.ndarray, sources: np.ndarray, sentinel: int) -> np.ndarray:
    """Hop distances from ``sources`` via frontier BFS over float32 matmuls.

    Returns an int32 (len(sources), n) matrix; unreachable = ``sentinel``.
    """
    n = a32.shape[0]
    s = len(sources)
    dist = np.full((s, n), sentinel, dtype=np.int32)
    reach = np.zeros((s, n), dtype=bool)
    dist[np.arange(s), sources] = 0
    reach[np.arange(s), sources] = True
    frontier = reach.astype(np.float32)
    d = 0
    while True:
        nxt = (frontier @ a32) > 0
        newf = nxt & ~reach
        if not newf.any():
            break
        d += 1
        dist[newf] = d
        reach |= newf
        frontier = newf.astype(np.float32)
    return dist


# --------------------------------------------------------------------------------
# Incremental APSP under 2-edge swaps (the dense SA tier's hot path)
# --------------------------------------------------------------------------------

@dataclasses.dataclass
class SwapToken:
    """Pending result of ``IncrementalAPSP.evaluate_swap`` or
    ``SymmetricAPSP.evaluate_swap`` (commit to apply)."""

    removed: tuple[tuple[int, int], ...]
    added: tuple[tuple[int, int], ...]
    # post-swap int32 distances: the (n, n) numpy matrix (IncrementalAPSP) or
    # the (s, n) rows on the evaluator's device (SymmetricAPSP)
    dist: np.ndarray | torch.Tensor
    total: int
    diam: int
    mpl: float


class IncrementalAPSP:
    """Dense APSP state maintained under 2-edge swaps by delta evaluation
    (the reference's ``IncrementalAPSP``, its numpy path).

    The evaluator keeps the current boolean adjacency, the int32 hop-distance
    matrix (sentinel ``n`` for unreachable) and the BFS-DAG parent-count
    matrix.  ``evaluate_swap`` prices a swap without mutating state:

    1. *Removals*: source ``s`` is affected by deleting edge (a, b) iff the
       edge is the sole DAG-parent edge of one endpoint (exact — if an
       endpoint keeps a parent, every vertex keeps a parent and all old
       distances stay achievable).  Distances are repaired by batched BFS
       from only the affected sources; unaffected rows (and, by symmetry,
       columns) are provably unchanged.
    2. *Additions*: the exact unweighted edge-insert formula
       ``d'(x, y) = min(d(x, y), d(x, u) + 1 + d(v, y), d(x, v) + 1 + d(u, y))``
       applied per added edge — vectorized O(n^2), no BFS.

    When more than ``full_rebuild_frac`` (0.9, the reference's default) of
    the sources are affected (or ``force_full`` is set, or the base state is
    disconnected) the evaluator
    falls back to a from-scratch batched BFS; ``n_delta`` / ``n_full`` count
    both paths as the reference's do.  The reference's C fast path
    (``use_c``) has no counterpart: this is the path it is held equal to.

    The state is tens of kilobytes at the n <= 64 where ``sa_search`` runs
    it, and a proposal costs microseconds, below one kernel launch, so it
    stays on the host.  All updates are written in place.
    """

    full_rebuild_frac = 0.9

    def __init__(self, adj: np.ndarray, force_full: bool = False):
        n = adj.shape[0]
        self.n = n
        self.sentinel = n
        self.force_full = force_full
        # bool input is adopted as the live buffer (mutated in place)
        self.adj = adj if adj.dtype == np.bool_ else adj.astype(bool)
        self.a32 = self.adj.astype(np.float32)
        self.nbr = _nbr_table(self.adj)
        self.dist = _bfs_rows(self.a32, np.arange(n), n)
        self.npar = _parent_counts(self.adj, self.dist, self.nbr)
        self.total = int(self.dist.sum(dtype=np.int64))
        self.diam = int(self.dist.max())
        self.n_delta = 0
        self.n_full = 0

    def _refresh_nbr_rows(self, verts) -> None:
        self.nbr = _refresh_nbr_rows(self.adj, self.nbr, verts)

    # -- public state ------------------------------------------------------
    @property
    def connected(self) -> bool:
        return self.diam < self.sentinel

    def mpl(self) -> float:
        if not self.connected:
            return float("inf")
        return self.total / (self.n * (self.n - 1))

    def diameter(self) -> float:
        return float(self.diam) if self.connected else float("inf")

    def as_float_dist(self) -> np.ndarray:
        """Distance matrix in the ``apsp`` convention (float, inf sentinel)."""
        out = self.dist.astype(float)
        out[self.dist >= self.sentinel] = np.inf
        return out

    # -- swap evaluation ---------------------------------------------------
    def _set_edges(self, edges, on: bool) -> None:
        for u, v in edges:
            self.adj[u, v] = self.adj[v, u] = on
            self.a32[u, v] = self.a32[v, u] = float(on)

    def evaluate_swap(self, removed: list[tuple[int, int]],
                      added: list[tuple[int, int]]) -> SwapToken:
        """Price the swap; returns a token (``commit`` applies it) with the
        exact post-swap distances, total, diameter and MPL.

        Removed edges must exist and added edges must not.  The edge lists
        may be arbitrarily long and may share vertices (batched multi-edge
        changes): the removal test counts lost parent edges per vertex
        exactly.  The reference's ``want_diameter`` switch (its C path may
        defer the diameter) has no counterpart.
        """
        dist, n = self.dist, self.n
        if not all(self.adj[u, v] for u, v in removed):
            raise ValueError("a removed edge is not in the graph")
        if any(self.adj[u, v] for u, v in added):
            raise ValueError("an added edge is already in the graph")

        # exact removal-affected sources (batched lost-parent test); a
        # disconnected base forces the full path, as in the reference
        aff = _removal_affected(dist, self.npar, removed)
        n_aff = int(aff.sum())

        if self.force_full or not self.connected \
                or n_aff > self.full_rebuild_frac * n:
            self.n_full += 1
            self._set_edges(removed, False)
            self._set_edges(added, True)
            try:
                new = _bfs_rows(self.a32, np.arange(n), self.sentinel)
            finally:
                self._set_edges(added, False)
                self._set_edges(removed, True)
            return self._token(removed, added, new)

        self.n_delta += 1
        new = dist.copy()
        if n_aff:
            # repair on the graph minus removed edges (additions come after)
            for u, v in removed:
                self.a32[u, v] = self.a32[v, u] = 0.0
            try:
                rows = _bfs_rows(self.a32, np.nonzero(aff)[0], self.sentinel)
            finally:
                for u, v in removed:
                    self.a32[u, v] = self.a32[v, u] = 1.0
            new[aff, :] = rows
            new[:, aff] = rows.T
        for u, v in added:
            du = new[:, u]
            dv = new[:, v]
            via = np.minimum(du[:, None] + (dv[None, :] + np.int32(1)),
                             dv[:, None] + (du[None, :] + np.int32(1)))
            np.minimum(new, via, out=new)
        return self._token(removed, added, new)

    def _token(self, removed, added, new: np.ndarray) -> SwapToken:
        total = int(new.sum(dtype=np.int64))
        diam = int(new.max())
        mpl = total / (self.n * (self.n - 1)) if diam < self.sentinel else float("inf")
        return SwapToken(tuple(removed), tuple(added), new, total, diam, mpl)

    def commit(self, token: SwapToken) -> None:
        """Apply a previously evaluated swap to the maintained state."""
        self._set_edges(token.removed, False)
        self._set_edges(token.added, True)
        self.dist[...] = token.dist
        self.total = token.total
        self.diam = token.diam
        self._refresh_nbr_rows([x for e in (*token.removed, *token.added) for x in e])
        self.npar[...] = _parent_counts(self.adj, self.dist, self.nbr)

    def reset(self) -> None:
        """Re-derive all state from the (externally rewritten) adjacency."""
        self.a32[...] = self.adj
        self.nbr = _nbr_table(self.adj)
        self.dist[...] = _bfs_rows(self.a32, np.arange(self.n), self.sentinel)
        self.npar[...] = _parent_counts(self.adj, self.dist, self.nbr)
        self.total = int(self.dist.sum(dtype=np.int64))
        self.diam = int(self.dist.max())

    def load_from(self, other: "IncrementalAPSP") -> None:
        """Copy another evaluator's state into this one (replica exchange)."""
        self.adj[...] = other.adj
        self.a32[...] = other.a32
        self.dist[...] = other.dist
        self.npar[...] = other.npar
        if self.nbr.shape == other.nbr.shape:
            self.nbr[...] = other.nbr
        else:
            self.nbr = other.nbr.copy()
        self.total = other.total
        self.diam = other.diam

    def verify(self) -> None:
        """Raise ``AssertionError`` unless the state equals a from-scratch
        host recompute (tests)."""
        ref = _bfs_rows(self.adj.astype(np.float32), np.arange(self.n), self.sentinel)
        if not (np.array_equal(self.dist, ref)
                and self.total == int(ref.sum(dtype=np.int64))
                and self.diam == int(ref.max())
                and np.array_equal(self.npar, _parent_counts(self.adj, self.dist))):
            raise AssertionError("incremental state diverged from a recompute")


# --------------------------------------------------------------------------------
# Symmetry-aware incremental APSP (the orbit-level search engine's hot path)
# --------------------------------------------------------------------------------

class SymmetricAPSP:
    """Row-restricted incremental APSP for rotationally symmetric graphs, its
    distance state on a device (the counterpart of the reference's
    ``SymmetricAPSP``).

    For a graph on ``n`` vertices invariant under rotation by ``shift``
    (``fold = n // shift`` symmetric copies), every distance follows from the
    rows of the ``shift`` representative sources ``0..shift-1``:

        d(x, y) = d(x mod shift, (y - (x - x mod shift)) mod n)

    so the evaluator keeps exactly those rows, an (s, n) int32 tensor on
    ``device`` (sentinel ``n``), and prices *orbit-level* edge swaps (unions
    of rotation orbits, so the graph stays symmetric) by delta evaluation:

    1. removals: the reference's exact batched lost-parent test
       (``_removal_affected_nbr``) selects the affected representative rows.
       It reads only the removed edges' endpoint columns and their
       neighbours' columns, so only those columns are copied home; the
       parent counts are gathered from them on demand, and the
       reference's maintained (s, n) count table is not kept (``npar``
       computes it when read).  The affected rows are re-swept
       (``bfs_sweep_kernel``) on the graph minus the removed orbits and
       copied into a clone of the state; the others are provably unchanged.
    2. insertions: the min-plus insert patch through the added-edge
       endpoints (``pack_patch``, ``patch_prologue``, then
       ``minplus_patch_kernel``): the endpoints' rows rolled by symmetry, a
       Floyd–Warshall closure over them, one pass over the state.

    A disconnected base state, ``force_full``, or more than
    ``full_rebuild_frac`` of the rows affected takes the full path instead:
    all s rows swept on the post-swap graph.  ``n_delta`` / ``n_full`` count
    the two paths and equal the reference's.  Totals are int32 row sums and
    the maximum taken on the device, finished as int64 on the host.

    ``device``: ``None`` is the CUDA device (raises without one), ``"cpu"``
    runs the kernels' plain versions.  ``bytes_to_device`` and
    ``bytes_to_host`` count the bytes the evaluator copies between host
    arrays and its device state.
    """

    def __init__(
        self,
        adj: np.ndarray,
        shift: int,
        full_rebuild_frac: float = 0.9,
        force_full: bool = False,
        device=None,
    ):
        n = adj.shape[0]
        if shift < 1 or n % shift:
            raise ValueError(f"shift={shift} must be a positive divisor of n={n}")
        self.device = resolve_device(device)
        _check_int32_sums(n, n)
        self.n = n
        self.s = shift
        self.fold = n // shift
        self.sentinel = n
        self.full_rebuild_frac = full_rebuild_frac
        self.force_full = force_full
        self.adj = adj if adj.dtype == np.bool_ else adj.astype(bool)
        if not np.array_equal(self.adj, np.roll(np.roll(self.adj, shift, 0), shift, 1)):
            raise ValueError(f"adjacency is not invariant under rotation by {shift}")
        self.nbr = _nbr_table(self.adj)
        self.bytes_to_device = self.bytes_to_host = 0
        self.dist = self._rows_bfs(np.arange(shift))
        self.total, self.diam = self._total_diam(self.dist)
        self.n_delta = 0
        self.n_full = 0

    # -- host <-> device ---------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        self.bytes_to_device += a.nbytes
        return bfs_sweep.as_words(a, self.device)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        self.bytes_to_host += t.numel() * t.element_size()
        return t.cpu().numpy()

    # -- graph state -------------------------------------------------------
    def _refresh_nbr_rows(self, verts) -> None:
        self.nbr = _refresh_nbr_rows(self.adj, self.nbr, verts)

    def _apply_edges(self, removed, added) -> None:
        for u, v in removed:
            self.adj[u, v] = self.adj[v, u] = False
        for u, v in added:
            self.adj[u, v] = self.adj[v, u] = True

    def _revert_edges(self, removed, added) -> None:
        for u, v in added:
            self.adj[u, v] = self.adj[v, u] = False
        for u, v in removed:
            self.adj[u, v] = self.adj[v, u] = True

    def _rows_bfs(self, sources: np.ndarray, removed=(), added=()) -> torch.Tensor:
        """BFS rows from ``sources`` on the current graph with ``removed``
        edges deleted and ``added`` edges inserted, as an (m, n) tensor on
        the device: ``bfs_sweep.bfs_rows_batched`` at b = 1, its uploads
        counted."""
        touched = [x for e in (*removed, *added) for x in e]
        self._apply_edges(removed, added)
        self._refresh_nbr_rows(touched)
        try:
            nb, vm, F0, _, _ = bfs_sweep.pack_batch(self.nbr[None], sources)
        finally:
            self._revert_edges(removed, added)
            self._refresh_nbr_rows(touched)
        rows = bfs_sweep.sweep(self._to_device(nb), self._to_device(vm),
                               self._to_device(F0), self.sentinel)
        return rows[0, : len(sources)].contiguous()

    # -- public state ------------------------------------------------------
    @property
    def connected(self) -> bool:
        return self.diam < self.sentinel

    def mpl(self) -> float:
        if not self.connected:
            return float("inf")
        return self.total / (self.s * (self.n - 1))

    def diameter(self) -> float:
        return float(self.diam) if self.connected else float("inf")

    @property
    def npar(self) -> np.ndarray:
        """The BFS-DAG parent counts of the representative rows, (s, n)
        int16, computed on demand from the state and the neighbour table."""
        return _parent_counts(self.adj, self.dist.cpu().numpy(), self.nbr)

    # -- swap evaluation ---------------------------------------------------
    def _check_orbit_closed(self, edges, kind: str) -> None:
        n, s = self.n, self.s
        es = {(min(u, v), max(u, v)) for u, v in edges}
        for u, v in es:
            a, b = (u + s) % n, (v + s) % n
            if (min(a, b), max(a, b)) not in es:
                raise ValueError(
                    f"{kind} edge set is not closed under rotation by {s}: "
                    f"({u},{v}) rotates to ({a},{b})")

    def _removal_affected(self, removed) -> np.ndarray:
        """The reference's lost-parent mask over the representative rows,
        from only the columns the test reads: the removed edges' endpoints
        and their neighbours, pulled in one gather and one copy, with the
        edges and the neighbour table renumbered into those columns."""
        if not removed:
            return np.zeros(self.s, dtype=bool)
        pts = np.array(sorted({x for e in removed for x in e}))
        nb = self.nbr[pts]
        cols = np.unique(np.concatenate([pts, nb[nb >= 0]]))
        local_nbr = np.full((len(cols), nb.shape[1]), -1, dtype=np.int32)
        local_nbr[np.searchsorted(cols, pts)] = np.where(nb >= 0, np.searchsorted(cols, nb), -1)
        local = dict(zip(cols.tolist(), range(len(cols))))
        sub = self._to_host(self.dist.index_select(1, self._to_device(cols)))
        return _removal_affected_nbr(sub, local_nbr,
                                     [(local[a], local[b]) for a, b in removed])

    def evaluate_swap(self, removed, added) -> SwapToken:
        """Price a batched orbit swap; returns a token (``commit`` applies it).

        ``removed`` / ``added`` are edge lists that must each be unions of
        rotation orbits (validated), with removed edges present and added
        edges absent.  Distances, total, diameter and MPL in the token are
        exact for the post-swap graph.
        """
        s = self.s
        self._check_orbit_closed(removed, "removed")
        self._check_orbit_closed(added, "added")
        if not all(self.adj[u, v] for u, v in removed):
            raise ValueError("a removed edge is not in the graph")
        if any(self.adj[u, v] for u, v in added):
            raise ValueError("an added edge is already in the graph")
        # a disconnected base state invalidates the sentinel-coded parent
        # counts used by the delta test: force the full rebuild
        if self.force_full or not self.connected:
            aff = None
        else:
            aff = self._removal_affected(removed)
        if aff is None or int(aff.sum()) > self.full_rebuild_frac * s:
            self.n_full += 1
            return self._token(removed, added, self._rows_bfs(np.arange(s), removed, added))

        self.n_delta += 1
        new = self.dist.clone()
        rows = np.nonzero(aff)[0]
        if len(rows):
            # repair on the graph minus removed orbits (still symmetric)
            new.index_copy_(0, self._to_device(rows), self._rows_bfs(rows, removed))
        if added:
            patch = bfs_sweep.pack_patch([added], s)
            tmp, crows = bfs_sweep.patch_prologue(
                new[None], *(self._to_device(a) for a in patch))
            new = bfs_sweep.patch_apply(new[None], tmp, crows)[0]
        return self._token(removed, added, new)

    def _total_diam(self, dist: torch.Tensor) -> tuple[int, int]:
        """(total, maximum) of (s, n) rows: int32 row sums and the maximum
        on the device, one copy home, the total finished as int64."""
        out = self._to_host(torch.cat([dist.sum(1, dtype=torch.int32),
                                       dist.amax().view(1)]))
        return int(out[:-1].sum(dtype=np.int64)), int(out[-1])

    def _token(self, removed, added, new: torch.Tensor) -> SwapToken:
        total, diam = self._total_diam(new)
        mpl = total / (self.s * (self.n - 1)) if diam < self.sentinel else float("inf")
        return SwapToken(tuple(removed), tuple(added), new, total, diam, mpl)

    def commit(self, token: SwapToken) -> None:
        """Apply a previously evaluated orbit swap to the maintained state
        (the token's rows are adopted, not copied)."""
        self._apply_edges(token.removed, token.added)
        self.dist = token.dist
        self.total = token.total
        self.diam = token.diam
        self._refresh_nbr_rows([x for e in (*token.removed, *token.added) for x in e])

    def verify(self) -> None:
        """Raise ``AssertionError`` unless the state equals a from-scratch
        host recompute and the symmetry assumption holds for the full matrix
        (tests)."""
        def need(cond, msg):
            if not cond:
                raise AssertionError(msg)

        need(np.array_equal(self.adj, np.roll(np.roll(self.adj, self.s, 0), self.s, 1)),
             "adjacency lost its rotational symmetry")
        need(np.array_equal(self.nbr, _nbr_table(self.adj, self.nbr.shape[1])),
             "neighbour table diverged from the adjacency")
        ref = _bfs_rows(self.adj.astype(np.float32), np.arange(self.n), self.sentinel)
        rows = ref[: self.s]
        need(np.array_equal(self.dist.cpu().numpy(), rows), "symmetric dist diverged")
        need(self.total == int(rows.sum(dtype=np.int64)), "total diverged")
        need(self.diam == int(rows.max()) == int(ref.max()), "diameter diverged")
        need(self.fold * self.total == int(ref.sum(dtype=np.int64)),
             "representative rows do not give the full total")
        need(np.array_equal(self.npar, _parent_counts(self.adj, rows)),
             "parent counts diverged")


# --------------------------------------------------------------------------------
# Whole-graph invariants
# --------------------------------------------------------------------------------

def mpl(g: Graph, dist: np.ndarray | None = None, device=None) -> float:
    """Mean path length over ordered distinct pairs (the paper's MPL)."""
    d = apsp(g, device) if dist is None else dist
    n = g.n
    off = ~np.eye(n, dtype=bool)
    vals = d[off]
    if not np.isfinite(vals).all():
        return float("inf")
    return float(vals.mean())


def eccentricities(g: Graph, dist: np.ndarray | None = None, device=None) -> np.ndarray:
    d = apsp(g, device) if dist is None else dist
    return d.max(axis=1)


def diameter(g: Graph, dist: np.ndarray | None = None, device=None) -> float:
    d = apsp(g, device) if dist is None else dist
    return float(d.max())


def girth(g: Graph) -> float:
    """Length of the shortest cycle (inf for forests). BFS from every vertex."""
    adj = g.adjacency_lists()
    best = np.inf
    for src in range(g.n):
        depth = [-1] * g.n
        parent = [-1] * g.n
        depth[src] = 0
        q = [src]
        while q:
            nq = []
            for u in q:
                for v in adj[u]:
                    if depth[v] == -1:
                        depth[v] = depth[u] + 1
                        parent[v] = u
                        nq.append(v)
                    elif v != parent[u]:
                        # cycle through src-ish: length bound
                        cyc = depth[u] + depth[v] + 1
                        if cyc < best:
                            best = cyc
            # early exit: any deeper layers can only give longer cycles
            if q and 2 * depth[q[0]] + 1 >= best:
                break
            q = nq
    return float(best)


def _cut_size(adj: np.ndarray, mask: np.ndarray) -> int:
    return int(adj[np.ix_(mask, ~mask)].sum())


def bisection_width(
    g: Graph,
    exact_limit: int = 20,
    restarts: int = 24,
    seed: int = 0,
) -> int:
    """Minimum edge cut over balanced bipartitions (|A| = ceil(n/2)).

    Exact (exhaustive over subsets containing vertex 0) for n <= exact_limit;
    otherwise Kernighan–Lin refinement from a spectral start and
    ``restarts`` random starts drawn from ``default_rng(seed)``: an upper
    bound on the true BW, equal to the reference's per (restarts, seed).
    """
    n = g.n
    adj = g.adjacency().astype(np.int64)
    half = n // 2
    if n <= exact_limit:
        best = np.inf
        for comb in itertools.combinations(range(1, n), half - 1):
            mask = np.zeros(n, dtype=bool)
            mask[0] = True
            mask[list(comb)] = True
            c = _cut_size(adj, mask)
            if c < best:
                best = c
        return int(best)

    rng = np.random.default_rng(seed)
    best = np.inf

    starts: list[np.ndarray] = []
    # spectral start: Fiedler vector median split
    try:
        lap = np.diag(adj.sum(1)) - adj
        _, v = np.linalg.eigh(lap)
        order = np.argsort(v[:, 1])
        mask = np.zeros(n, dtype=bool)
        mask[order[:half]] = True
        starts.append(mask)
    except np.linalg.LinAlgError:  # pragma: no cover
        pass
    for _ in range(restarts):
        perm = rng.permutation(n)
        mask = np.zeros(n, dtype=bool)
        mask[perm[:half]] = True
        starts.append(mask)

    for mask in starts:
        mask = _kernighan_lin(adj, mask.copy())
        c = _cut_size(adj, mask)
        if c < best:
            best = c
    return int(best)


def _kernighan_lin(adj: np.ndarray, mask: np.ndarray, max_passes: int = 12) -> np.ndarray:
    """Classic KL pass-based refinement of a balanced bipartition."""
    n = adj.shape[0]
    for _ in range(max_passes):
        a_side = np.where(mask)[0]
        b_side = np.where(~mask)[0]
        # gains for swapping pairs; do greedy sequence with locking
        locked = np.zeros(n, dtype=bool)
        cur = mask.copy()
        seq: list[tuple[int, int, int]] = []
        ext = adj @ (~cur).astype(np.int64)
        innr = adj @ cur.astype(np.int64)
        D = np.where(cur, ext - innr, innr - ext)  # benefit of moving v across
        for _step in range(min(len(a_side), len(b_side))):
            acand = [v for v in a_side if not locked[v]]
            bcand = [v for v in b_side if not locked[v]]
            if not acand or not bcand:
                break
            # best pair by D[a] + D[b] - 2 adj[a,b]; search top few by D to stay fast
            acand = sorted(acand, key=lambda v: -D[v])[:8]
            bcand = sorted(bcand, key=lambda v: -D[v])[:8]
            bg, ba, bb = -np.inf, -1, -1
            for va in acand:
                for vb in bcand:
                    gain = D[va] + D[vb] - 2 * adj[va, vb]
                    if gain > bg:
                        bg, ba, bb = gain, va, vb
            seq.append((int(bg), ba, bb))
            locked[ba] = locked[bb] = True
            # update D for unlocked vertices as if swapped
            for v in range(n):
                if locked[v]:
                    continue
                if cur[v]:  # same side as ba
                    D[v] += 2 * adj[v, ba] - 2 * adj[v, bb]
                else:
                    D[v] += 2 * adj[v, bb] - 2 * adj[v, ba]
        # find best prefix
        run, best_run, best_idx = 0, 0, -1
        for i, (gain, _, _) in enumerate(seq):
            run += gain
            if run > best_run:
                best_run, best_idx = run, i
        if best_run <= 0:
            break
        for i in range(best_idx + 1):
            _, va, vb = seq[i]
            mask[va] = False
            mask[vb] = True
    return mask


def _static_routes(g: Graph) -> np.ndarray:
    """Next hop of the static shortest-path route u -> v (-1 if none): the
    reference routing table's Floyd–Warshall, whose strict '<' breaks ties
    towards the lowest intermediate vertex."""
    n = g.n
    dist = np.full((n, n), np.inf)
    nxt = np.full((n, n), -1, dtype=np.int64)
    np.fill_diagonal(dist, 0.0)
    for u, v in g.edges:
        dist[u, v] = dist[v, u] = 1.0
        nxt[u, v] = v
        nxt[v, u] = u
    for k in range(n):
        alt = dist[:, k, None] + dist[None, k, :]
        better = alt < dist - 1e-12
        if better.any():
            dist = np.where(better, alt, dist)
            nxt = np.where(better, nxt[:, k, None], nxt)
    return nxt


def edge_betweenness_proxy(g: Graph) -> dict[tuple[int, int], float]:
    """Cheap congestion proxy: number of shortest-path pairs through each
    directed link under single-shortest-path (lowest-next-hop) static
    routing, one unit flow per ordered pair — the reference routing table's
    ``link_loads()``.  Routing-independent and used only for reporting (the
    reference's unused ``dist`` argument is dropped)."""
    n = g.n
    nxt = _static_routes(g)
    loads: dict[tuple[int, int], float] = {}
    for src in range(n):
        for dst in range(n):
            if src == dst:
                continue
            if nxt[src, dst] < 0:
                raise ValueError(f"no route {src}->{dst}")
            cur = src
            while cur != dst:
                hop = int(nxt[cur, dst])
                loads[(cur, hop)] = loads.get((cur, hop), 0.0) + 1.0
                cur = hop
    return loads


# --------------------------------------------------------------------------------

class GraphStats:
    __slots__ = ("name", "n", "k", "diameter", "mpl", "bw", "girth", "d_lb", "mpl_lb")

    def __init__(self, name, n, k, diameter, mpl, bw, girth, d_lb, mpl_lb):
        self.name, self.n, self.k = name, n, k
        self.diameter, self.mpl, self.bw, self.girth = diameter, mpl, bw, girth
        self.d_lb, self.mpl_lb = d_lb, mpl_lb

    def row(self) -> str:
        return (
            f"{self.name:>24s}  N={self.n:<4d} k={self.k:<3d} D={self.diameter:<4.0f} "
            f"MPL={self.mpl:<7.4f} BW={self.bw:<4d} girth={self.girth:<3.0f} "
            f"D_lb={self.d_lb} MPL_lb={self.mpl_lb:.4f}"
        )


def stats(g: Graph, bw_restarts: int = 24, seed: int = 0, device=None) -> GraphStats:
    """The paper's invariants of ``g``: its distances on ``device`` (``apsp``),
    the bisection width and girth on the host."""
    d = apsp(g, device)
    # irregular graphs (e.g. cluster-hub compositions) report max degree;
    # the lower bounds below stay valid since they are monotone in k
    k = g.degree() if g.is_regular() else int(g.degrees().max())
    return GraphStats(
        name=g.name,
        n=g.n,
        k=k,
        diameter=diameter(g, d),
        mpl=mpl(g, d),
        bw=bisection_width(g, restarts=bw_restarts, seed=seed),
        girth=girth(g),
        d_lb=diameter_lower_bound(g.n, k),
        mpl_lb=mpl_lower_bound(g.n, k),
    )
