"""Hamiltonian cycle extraction (the counterpart of
``repro.core.hamiltonian``, a numpy copy held equal by the tests).

Ring collectives cost one hop per step *iff* consecutive ranks are adjacent
in the physical graph — i.e. the rank order follows a Hamiltonian cycle.
Every graph the paper's search produces embeds the ring 0..n-1 by
construction; for foreign topologies (torus, dragonfly, chvatal) we find one:
analytic snake for tori, bounded DFS with degree-ordered branching otherwise.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .graphs import Graph

__all__ = ["has_embedded_ring", "torus_hamiltonian", "hamiltonian_cycle"]


def has_embedded_ring(g: Graph) -> bool:
    es = set(g.edges)
    return all(((i, i + 1) if i + 1 < g.n else (0, i)) in es for i in range(g.n)) \
        if g.n > 2 else False


def torus_hamiltonian(dims: Sequence[int]) -> list[int]:
    """Boustrophedon (snake) cycle through a torus/mesh of even total size."""
    dims = [d for d in dims if d > 1]
    strides = np.cumprod([1] + list(dims[:-1]))

    def idx(coord):
        return int(sum(c * s for c, s in zip(coord, strides)))

    # recursive snake: iterate the last axis outermost, snaking the rest
    def snake(ds):
        if len(ds) == 1:
            return [[i] for i in range(ds[0])]
        inner = snake(ds[:-1])
        out = []
        for j in range(ds[-1]):
            seq = inner if j % 2 == 0 else inner[::-1]
            out.extend([c + [j] for c in seq])
        return out

    order = [idx(c) for c in snake(list(dims))]
    return order


def hamiltonian_cycle(g: Graph, budget: int = 2_000_000) -> list[int] | None:
    """Deterministic DFS for a Hamiltonian cycle; None if budget exhausted.

    Returns vertex order [v0, v1, ..., v_{n-1}] with consecutive (and wrap)
    pairs adjacent.  Prefers the embedded ring when present (O(1)).
    """
    n = g.n
    if n < 3:
        return None
    if has_embedded_ring(g):
        return list(range(n))
    adj = g.adjacency_lists()
    # Warnsdorff-style: visit lowest-remaining-degree neighbours first
    steps = 0
    path = [0]
    used = [False] * n
    used[0] = True

    def dfs() -> bool:
        nonlocal steps
        steps += 1
        if steps > budget:
            return False
        u = path[-1]
        if len(path) == n:
            return 0 in adj[u]
        cands = [v for v in adj[u] if not used[v]]
        cands.sort(key=lambda v: sum(1 for w in adj[v] if not used[w]))
        for v in cands:
            used[v] = True
            path.append(v)
            if dfs():
                return True
            path.pop()
            used[v] = False
        return False

    if dfs():
        return path
    return None
