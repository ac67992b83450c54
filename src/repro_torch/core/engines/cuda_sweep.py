"""Batched device pricing of the replica polish (the counterpart of
``repro.core.engines.pallas_sweep``'s ``sharded_rows_totals`` and
``sharded_delta_state``).

On one card the replica axis is just the batch axis of one launch: all R*M
proposals of an iteration go through one ``bfs_sweep_kernel`` launch (and,
under delta pricing, one ``minplus_patch_kernel`` launch), and only the
per-proposal (total, max) scalars come home.  Inputs and outputs are the
reference's: numpy in, ``(totals int64, maxima int32[, state])`` out, with
the state a (b, s, n) int32 tensor left on the device.  On a CPU device the
kernels' plain versions run instead.
"""
from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ...kernels import bfs_sweep
from ...kernels.bfs_sweep import as_words

__all__ = ["sharded_rows_totals", "sharded_delta_state"]


def _check_int32_sums(n: int, sentinel: int) -> None:
    # per-source row sums are taken in int32, as in the reference (one row
    # sums to at most n * sentinel); PATCH_INF's headroom needs n <= 46340 too
    if n * sentinel > np.iinfo(np.int32).max:
        raise NotImplementedError(
            f"device pricing needs n * sentinel <= int32 max (n={n}, "
            f"sentinel={sentinel})")


def _totals_maxima(rows: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(b, m, n) distances -> (b,) int64 totals and (b,) int32 maxima; the
    int32 row sums are finished as int64 on the host."""
    rowsums = rows.sum(2, dtype=torch.int32).cpu().numpy()
    return rowsums.sum(1, dtype=np.int64), rows.amax(dim=(1, 2)).cpu().numpy()


def sharded_rows_totals(
    nbrs: np.ndarray,
    n_sources: int,
    sentinel: int,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Price R stacked graphs in one dispatch.

    ``nbrs`` is (R, n, kmax) padded neighbour tables; BFS runs from sources
    ``0..n_sources-1`` of every graph (the representative rows of the
    symmetric tier).  Returns (totals (R,) int64, maxima (R,) int32).
    """
    dev = resolve_device(device)
    _, n, _ = nbrs.shape
    _check_int32_sums(n, sentinel)
    m = n_sources
    nb, vm, F0, _, _ = bfs_sweep.pack_batch(nbrs, np.arange(m))
    rows = bfs_sweep.sweep(as_words(nb, dev), as_words(vm, dev),
                           as_words(F0, dev), sentinel)
    return _totals_maxima(rows[:, :m, :])


def sharded_delta_state(
    base,
    nbrs: np.ndarray,
    sources_list,
    patches,
    sentinel: int,
    device=None,
):
    """Price b = R*M proposal graphs incrementally in one dispatch.

    Proposal i re-sweeps only its ``sources_list[i]`` rows on its
    ``nbrs[i]`` (n, kmax) table (the post-removal graph), merges them into
    its chain's rows of ``base`` (R, s, n) — numpy, or a tensor already on
    the device — and applies the min-plus insert patch for ``patches[i]``
    (the added edge list, or None).  Proposal i belongs to chain ``i // M``.

    Returns ``(totals (b,) int64, maxima (b,) int32, state)``, the state
    being the (b, s, n) int32 post-swap rows on the device.
    """
    dev = resolve_device(device)
    base = torch.as_tensor(base, device=dev)
    r, s, n = base.shape
    b = nbrs.shape[0]
    if b % r:
        raise ValueError(f"proposal batch {b} is not a multiple of replicas {r}")
    _check_int32_sums(n, sentinel)
    nb, vm, F0, ids, _, _ = bfs_sweep.pack_delta_batch(nbrs, sources_list, s)
    patch = bfs_sweep.pack_patch(patches, s)
    rows = bfs_sweep.sweep(as_words(nb, dev), as_words(vm, dev),
                           as_words(F0, dev), sentinel)
    merged = base.repeat_interleave(b // r, dim=0)
    # re-swept rows replace their representative rows; idle lanes carry
    # id == s (out of range) and are left out of the scatter
    lane_b, lane_j = np.nonzero(ids < s)
    if len(lane_b):
        lb = torch.from_numpy(lane_b).to(dev)
        merged[lb, torch.from_numpy(ids[lane_b, lane_j].astype(np.int64)).to(dev)] = \
            rows[lb, torch.from_numpy(lane_j).to(dev)]
    del rows
    tmp, crows = bfs_sweep.patch_prologue(merged, *(torch.from_numpy(a).to(dev)
                                                    for a in patch))
    state = bfs_sweep.patch_apply(merged, tmp, crows)
    totals, maxima = _totals_maxima(state)
    return totals, maxima, state
