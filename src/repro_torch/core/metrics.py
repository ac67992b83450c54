"""Host-side graph helpers of the replica polish, as numpy.

Copies of ``_nbr_table``, ``_parent_count_cols``, ``_removal_affected_nbr``
and the Cerf et al. lower bounds from ``repro.core.metrics``, unchanged: the
batched lost-parent removal test runs on the host against each chain's
mirrored distance rows, exactly as in the reference.
"""
from __future__ import annotations

import numpy as np

__all__ = [
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
