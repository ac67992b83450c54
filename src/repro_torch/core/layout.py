"""Topology-aware logical→physical layout (the counterpart of
``repro.core.layout``; the annealer is a numpy copy held equal by the tests).

The paper optimizes the *physical* graph for minimal MPL.  A fleet adds a
second, free knob: the order in which physical devices are laid into the
mesh decides which device pairs the per-axis collectives talk between.
Formally this is a quadratic assignment problem:

    minimize_π  Σ_{i,j} traffic[i, j] · hops[π(i), π(j)]

where ``traffic`` is the logical rank-to-rank byte matrix implied by the mesh
axes and their collectives, and ``hops`` is the physical graph's APSP matrix.
We solve it with the same annealer the paper uses for MPL (swap two ranks ==
edge swap in permutation space).

Where the port differs: :func:`optimize_layout` takes ``device``, where its
one call of :func:`metrics.apsp` sweeps every source of the graph
(``bfs_sweep_kernel`` on a CUDA device, its plain version on the CPU;
``None`` is the CUDA device and raises without one).  The annealer stays on
the host: the same ``default_rng(seed)`` draws in the same order and the same
float64 sums in the same order, so ``perm``, ``cost`` and ``identity_cost``
equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import metrics
from .graphs import Graph

__all__ = [
    "mesh_traffic",
    "layout_cost",
    "optimize_layout",
    "LayoutResult",
]


def mesh_traffic(axis_sizes: tuple[int, ...], axis_bytes: tuple[float, ...]) -> np.ndarray:
    """Logical rank-to-rank traffic matrix for a mesh of ``axis_sizes``.

    ``axis_bytes[a]`` = bytes each rank exchanges *per neighbour step* with its
    ring neighbours along axis ``a`` (ring/pairwise collective traffic).
    Returns a dense (n, n) symmetric matrix, n = Π axis_sizes.
    """
    n = int(np.prod(axis_sizes))
    t = np.zeros((n, n))
    coords = np.array(np.unravel_index(np.arange(n), axis_sizes, order="F")).T
    for a, (size, b) in enumerate(zip(axis_sizes, axis_bytes)):
        if size < 2 or b <= 0:
            continue
        for r in range(n):
            c = coords[r].copy()
            c[a] = (c[a] + 1) % size
            r2 = int(np.ravel_multi_index(c, axis_sizes, order="F"))
            t[r, r2] += b
            t[r2, r] += b
    return t


def layout_cost(traffic: np.ndarray, hops: np.ndarray, perm: np.ndarray) -> float:
    """Σ traffic[i,j] · hops[perm[i], perm[j]] over ordered pairs."""
    h = hops[np.ix_(perm, perm)]
    return float((traffic * h).sum())


@dataclasses.dataclass
class LayoutResult:
    perm: np.ndarray  # logical rank i -> physical node perm[i]
    cost: float
    identity_cost: float
    iterations: int

    @property
    def improvement(self) -> float:
        if self.identity_cost == 0:
            return 0.0
        return 1.0 - self.cost / self.identity_cost


def optimize_layout(
    g: Graph,
    traffic: np.ndarray,
    seed: int = 0,
    n_iter: int = 20000,
    t_start: float | None = None,
    t_end_frac: float = 1e-4,
    device=None,
) -> LayoutResult:
    """SA over rank-swap moves for the QAP above (paper's annealer, new
    objective); the hop matrix is ``metrics.apsp`` on ``device``."""
    n = g.n
    if traffic.shape != (n, n):
        raise ValueError(f"traffic must be ({n},{n})")
    hops = metrics.apsp(g, device=device)
    if not np.isfinite(hops).all():
        raise ValueError("graph disconnected")
    rng = np.random.default_rng(seed)
    perm = np.arange(n)
    cur = layout_cost(traffic, hops, perm)
    ident = cur
    best, best_perm = cur, perm.copy()
    t0 = t_start if t_start is not None else max(cur * 0.01, 1e-9)
    gamma = math.exp(math.log(t_end_frac) / n_iter)
    t = t0
    # incremental delta evaluation: swapping ranks a,b only changes rows/cols a,b
    for _ in range(n_iter):
        t *= gamma
        a, b = rng.integers(n), rng.integers(n)
        if a == b:
            continue
        p2 = perm.copy()
        p2[a], p2[b] = p2[b], p2[a]
        rows = np.array([a, b])
        old = (traffic[rows] * hops[np.ix_(perm[rows], perm)]).sum() * 2 - (
            traffic[np.ix_(rows, rows)] * hops[np.ix_(perm[rows], perm[rows])]
        ).sum()
        new = (traffic[rows] * hops[np.ix_(p2[rows], p2)]).sum() * 2 - (
            traffic[np.ix_(rows, rows)] * hops[np.ix_(p2[rows], p2[rows])]
        ).sum()
        d = new - old
        if d < 0 or rng.random() < math.exp(-d / max(t, 1e-12)):
            perm = p2
            cur += d
            if cur < best:
                best, best_perm = cur, perm.copy()
    return LayoutResult(perm=best_perm, cost=best, identity_cost=ident, iterations=n_iter)
