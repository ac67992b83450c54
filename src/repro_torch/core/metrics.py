"""Graph metrics of the search: the host helpers of the replica polish and
the symmetry-aware incremental evaluator ``SymmetricAPSP``.

``_nbr_table``, ``_parent_counts``, ``_parent_count_cols``,
``_removal_affected_nbr`` and the Cerf et al. lower bounds are numpy copies
of ``repro.core.metrics``'s, unchanged: the batched lost-parent removal test
runs on the host, against each replica chain's mirrored distance rows and
against the columns ``SymmetricAPSP`` pulls from its device state, exactly
as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import bfs_sweep
from .engines.cuda_sweep import _check_int32_sums

__all__ = [
    "SwapToken",
    "SymmetricAPSP",
    "moore_bound_vertices",
    "diameter_lower_bound",
    "mpl_lower_bound",
]


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
    aff = np.zeros(dist.shape[0], dtype=bool)
    lost: dict[int, np.ndarray] = {}
    for a, b in removed:
        da, db = dist[:, a], dist[:, b]
        pa_of_b = (da + 1 == db).astype(np.int16)
        pa_of_a = (db + 1 == da).astype(np.int16)
        lost[b] = pa_of_b if b not in lost else lost[b] + pa_of_b
        lost[a] = pa_of_a if a not in lost else lost[a] + pa_of_a
    for x, cnt in lost.items():
        aff |= (cnt > 0) & (cnt == npc[:, idx[x]])
    return aff



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
# Symmetry-aware incremental APSP (the orbit-level search engine's hot path)
# --------------------------------------------------------------------------------

@dataclasses.dataclass
class SwapToken:
    """Pending result of ``SymmetricAPSP.evaluate_swap`` (commit to apply)."""

    removed: tuple[tuple[int, int], ...]
    added: tuple[tuple[int, int], ...]
    dist: torch.Tensor  # post-swap (s, n) int32 rows on the evaluator's device
    total: int
    diam: int
    mpl: float


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
        for u in sorted(set(verts)):
            ws = np.nonzero(self.adj[u])[0]
            if len(ws) > self.nbr.shape[1]:
                self.nbr = _nbr_table(self.adj, int(self.adj.sum(1).max()))
                return
            self.nbr[u, :] = -1
            self.nbr[u, : len(ws)] = ws

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
