"""Failure detection and elastic remeshing (the counterpart of
``repro.runtime.failures``, held equal by the tests).

Every worker heartbeats to a coordinator.  ``FailureDetector`` is that logic
(timeout => dead), simulatable in tests by feeding synthetic clocks.  When
nodes die, ``plan_elastic_remesh`` produces the recovery plan:

  1. drop dead nodes from the interconnect graph;
  2. choose the largest usable mesh shape from the survivors;
  3. re-run the paper's MPL/QAP layout optimization (core.layout) on the
     *surviving subgraph* so the shrunken mesh again sits on a minimal-hop
     communication pattern;
  4. the trainer restores the latest checkpoint with the new mesh's
     shardings and resumes.

Where the port differs: ``plan_elastic_remesh`` takes ``device``, where its
``apsp`` and ``optimize_layout`` calls sweep the survivor graph
(``bfs_sweep_kernel`` on a CUDA device, its plain version on the CPU;
``None`` is the CUDA device and raises without one).  The survivors' hop
matrix is computed once, for the connectivity test and the fallback both
(the reference computes it twice for a disconnected graph).  A disconnected
survivor graph falls back to vertex 0's component, as the reference's code
does (its comment says the largest component); the component's index is a
dict rather than ``list.index``, with the same result, so the fallback stays
cheap at thousands of survivors.

``StragglerPolicy`` holds thresholds for the trainer's per-step wall-time
watch.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Iterable

import numpy as np

from ..core import layout, metrics
from ..core.graphs import Graph, from_edges

__all__ = ["FailureDetector", "RemeshPlan", "plan_elastic_remesh", "StragglerPolicy",
           "surviving_subgraph"]


@dataclasses.dataclass
class FailureDetector:
    """Heartbeat-timeout failure detector."""

    n_nodes: int
    timeout_s: float = 10.0
    last_seen: dict = dataclasses.field(default_factory=dict)

    def heartbeat(self, node: int, t: float | None = None) -> None:
        self.last_seen[node] = time.monotonic() if t is None else t

    def dead(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        out = []
        for node in range(self.n_nodes):
            seen = self.last_seen.get(node)
            if seen is None or now - seen > self.timeout_s:
                out.append(node)
        return out


def surviving_subgraph(g: Graph, dead: Iterable[int]) -> tuple[Graph, list[int]]:
    """Induced subgraph on survivors + the survivor-id mapping (new -> old)."""
    dead = set(dead)
    alive = [v for v in range(g.n) if v not in dead]
    remap = {old: new for new, old in enumerate(alive)}
    edges = [(remap[u], remap[v]) for u, v in g.edges if u not in dead and v not in dead]
    return from_edges(len(alive), edges, g.name + f"-minus{len(dead)}"), alive


@dataclasses.dataclass
class RemeshPlan:
    mesh_shape: tuple[int, ...]
    device_order: list[int]  # physical node ids (original numbering), mesh order
    dropped: list[int]
    layout_cost: float
    layout_improvement: float
    connected: bool


def _largest_mesh(n: int, axes: int = 2) -> tuple[int, ...]:
    """Largest power-of-two mesh with <= n devices, axes split near-evenly."""
    k = int(math.log2(max(n, 1)))
    if 2 ** k > n:  # guard float edge cases
        k -= 1
    ax = [k // axes + (1 if i < k % axes else 0) for i in range(axes)]
    return tuple(2 ** a for a in ax)


def plan_elastic_remesh(
    g: Graph,
    dead: Iterable[int],
    axis_bytes: tuple[float, ...] = (1.0, 8.0),
    seed: int = 0,
    layout_iters: int = 4000,
    device=None,
) -> RemeshPlan:
    """Recovery plan after failures: shrink the mesh, re-optimize the layout."""
    sub, alive = surviving_subgraph(g, dead)
    d = metrics.apsp(sub, device=device)
    connected = metrics.is_connected(sub, d)
    shape = _largest_mesh(sub.n, axes=len(axis_bytes))
    use = int(np.prod(shape))
    if not connected:
        # fall back to vertex 0's component (the reference's behaviour)
        comp_mask = np.isfinite(d[0])
        comp = [i for i in range(sub.n) if comp_mask[i]]
        index = {v: i for i, v in enumerate(comp)}
        sub2_edges = [(index[u], index[v]) for u, v in sub.edges
                      if u in index and v in index]
        alive = [alive[i] for i in comp]
        sub = from_edges(len(comp), sub2_edges, sub.name + "-cc")
        shape = _largest_mesh(sub.n, axes=len(axis_bytes))
        use = int(np.prod(shape))
    # layout the logical mesh on the first `use` survivors, optimized over the
    # whole surviving subgraph (QAP with zero traffic on spare nodes)
    traffic = np.zeros((sub.n, sub.n))
    traffic[:use, :use] = layout.mesh_traffic(shape, axis_bytes)
    res = layout.optimize_layout(sub, traffic, seed=seed, n_iter=layout_iters, device=device)
    order = [alive[res.perm[i]] for i in range(use)]
    return RemeshPlan(
        mesh_shape=shape,
        device_order=order,
        dropped=sorted(set(range(g.n)) - set(alive)),
        layout_cost=res.cost,
        layout_improvement=res.improvement,
        connected=True,
    )


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    factor: float = 3.0       # step slower than factor×median => straggler
    window: int = 50          # median window
    evict_after: int = 10     # persistent stragglers => treat as failure
