"""Graph representation and the two constructors the replica polish needs.

A copy of ``Graph``, ``_canon_edges``, ``from_edges``, ``ring`` and
``circulant`` from ``repro.core.graphs`` (the port imports nothing of
``repro``); the tests hold the copies equal to the originals.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Sequence

import numpy as np

__all__ = ["Graph", "from_edges", "ring", "circulant"]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable undirected simple graph."""

    n: int
    edges: tuple[tuple[int, int], ...]  # sorted (u < v) tuples, lexicographic
    name: str = "graph"

    # --- derived, cached lazily -------------------------------------------------
    def __post_init__(self):
        for u, v in self.edges:
            if not (0 <= u < self.n and 0 <= v < self.n):
                raise ValueError(f"edge ({u},{v}) out of range for n={self.n}")
            if u == v:
                raise ValueError(f"self-loop at {u}")
        if len(set(self.edges)) != len(self.edges):
            raise ValueError("duplicate edges")

    @property
    def m(self) -> int:
        return len(self.edges)

    def adjacency(self) -> np.ndarray:
        """Dense boolean adjacency matrix (symmetric)."""
        a = np.zeros((self.n, self.n), dtype=bool)
        for u, v in self.edges:
            a[u, v] = True
            a[v, u] = True
        return a

    def neighbors(self, u: int) -> list[int]:
        out = []
        for a, b in self.edges:
            if a == u:
                out.append(b)
            elif b == u:
                out.append(a)
        return sorted(out)

    def adjacency_lists(self) -> list[list[int]]:
        out: list[list[int]] = [[] for _ in range(self.n)]
        for u, v in self.edges:
            out[u].append(v)
            out[v].append(u)
        return [sorted(nb) for nb in out]

    def degrees(self) -> np.ndarray:
        d = np.zeros(self.n, dtype=np.int64)
        for u, v in self.edges:
            d[u] += 1
            d[v] += 1
        return d

    def is_regular(self) -> bool:
        d = self.degrees()
        return bool(np.all(d == d[0])) if self.n else True

    def degree(self) -> int:
        d = self.degrees()
        if not np.all(d == d[0]):
            raise ValueError(f"{self.name} is not regular: degrees {sorted(set(d.tolist()))}")
        return int(d[0])

    def has_edge(self, u: int, v: int) -> bool:
        if u > v:
            u, v = v, u
        return (u, v) in set(self.edges)

    def with_name(self, name: str) -> "Graph":
        return Graph(self.n, self.edges, name)

    def relabel(self, perm: Sequence[int]) -> "Graph":
        """Relabel vertices: vertex i becomes perm[i]."""
        p = list(perm)
        if sorted(p) != list(range(self.n)):
            raise ValueError("perm must be a permutation of range(n)")
        edges = _canon_edges((p[u], p[v]) for u, v in self.edges)
        return Graph(self.n, edges, self.name + "-relabeled")


def _canon_edges(edges: Iterable[tuple[int, int]]) -> tuple[tuple[int, int], ...]:
    es = sorted({(min(u, v), max(u, v)) for u, v in edges})
    return tuple(es)


def from_edges(n: int, edges: Iterable[tuple[int, int]], name: str = "graph") -> Graph:
    return Graph(n, _canon_edges(edges), name)


def ring(n: int) -> Graph:
    """(N,2)-Ring: the Hamiltonian cycle itself."""
    if n < 3:
        raise ValueError("ring needs n >= 3")
    return from_edges(n, ((i, (i + 1) % n) for i in range(n)), f"({n},2)-Ring")


def circulant(n: int, offsets: Sequence[int], name: str | None = None) -> Graph:
    """Circulant graph C_n(s1, ..., sk): vertex i ~ i±s (mod n).

    Circulants are vertex-transitive with full rotational symmetry — exactly the
    symmetric family the paper restricts its large-scale search to.  An offset
    equal to n/2 (n even) contributes degree 1; every other offset degree 2.
    """
    offs = sorted({s % n for s in offsets} - {0})
    if not offs:
        raise ValueError("need at least one nonzero offset")
    edges = []
    for i in range(n):
        for s in offs:
            edges.append((i, (i + s) % n))
    g = from_edges(n, edges, name or f"C{n}({','.join(map(str, offs))})")
    return g

