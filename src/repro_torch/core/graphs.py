"""Graph representation and the topology constructors of the paper's
benchmarked families (the counterpart of ``repro.core.graphs``).

Copies of the reference's ``Graph``, ``_canon_edges``, ``from_edges`` and
every constructor: ``ring``, ``complete``, ``circulant``, ``wagner``,
``bidiakis``, ``chvatal``, ``chvatal32``, ``petersen``, ``torus``,
``hypercube``, ``dragonfly``, ``random_regular``,
``random_hamiltonian_regular`` (the SA start), ``nested_compose`` and
``cluster_hub``, with ``REGISTRY`` naming them, and the deprecated
``build``, which delegates to ``topologies.build_topology``.  The port
imports nothing of ``repro``; the tests hold every constructor's edges
equal to the original's.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections.abc import Iterable, Sequence

import numpy as np

__all__ = [
    "Graph",
    "from_edges",
    "ring",
    "complete",
    "wagner",
    "bidiakis",
    "chvatal",
    "chvatal32",
    "petersen",
    "circulant",
    "torus",
    "hypercube",
    "dragonfly",
    "random_regular",
    "random_hamiltonian_regular",
    "nested_compose",
    "cluster_hub",
    "build",
    "REGISTRY",
]


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


def complete(n: int) -> Graph:
    return from_edges(n, itertools.combinations(range(n), 2), f"K{n}")


def wagner(n: int) -> Graph:
    """Wagner graph generalization: Möbius–Kantor-style circulant C_n(1, n/2).

    The classic Wagner graph is V8 = C_8(1,4); the paper extends it to N=16,32,
    256 as the ring + diameters ("Möbius ladder").  Degree 3, requires even n.
    """
    if n % 2:
        raise ValueError("wagner needs even n")
    return circulant(n, [1, n // 2], f"({n},3)-Wagner")


def bidiakis(n: int) -> Graph:
    """Bidiakis cube (n=12) and its cubic generalization (n divisible by 8).

    The paper does not spell out its N=16/32/256 'Bidiakis' construction; we
    reconstructed a deterministic cubic family that reproduces the published
    invariants *exactly* (asserted in tests):

        n=16:  D=5,  MPL=2.5333 (paper 2.53),  BW=4
        n=32:  D=9,  MPL=4.0645 (paper 4.06),  BW=4
        n=256: D=65, MPL=25.0902 (paper 25.09), BW=4

    Construction: split the ring into 4 blocks of b = n/4 vertices.  Within
    each block add the nested arcs (j, b-1-j) for j = 0..b/2-2 (the Bidiakis
    cube's 'rungs'); the two middle vertices of each block take the long
    'axle' chords of span n/2+1 and n/2-1, which pair up consistently with
    the antipodal block.  The n=12 classic cube (LCF [-6,4,-4]^4) is
    special-cased since b=3 is odd there.
    """
    if n == 12:
        edges = [(i, (i + 1) % 12) for i in range(12)]
        edges += [(0, 6), (3, 9), (1, 5), (2, 10), (4, 8), (7, 11)]
        return from_edges(12, edges, "(12,3)-Bidiakis")
    if n % 8:
        raise ValueError("generalized bidiakis needs n divisible by 8 (or n=12)")
    b = n // 4
    edges = [(i, (i + 1) % n) for i in range(n)]
    for t in range(4):
        base = t * b
        for j in range(b // 2 - 1):
            edges.append(((base + j) % n, (base + b - 1 - j) % n))
        edges.append(((base + b // 2 - 1) % n, (base + b // 2 - 1 + n // 2 + 1) % n))
        edges.append(((base + b // 2) % n, (base + b // 2 + n // 2 - 1) % n))
    return from_edges(n, edges, f"({n},3)-Bidiakis")


def chvatal() -> Graph:
    """The Chvátal graph: 12 vertices, 4-regular, girth 4, diameter 2.

    The paper uses a 32-vertex degree-4 'Chvatal' — see ``chvatal32``.
    Standard edge list (Bondy & Murty).
    """
    edges = [
        (0, 1), (0, 4), (0, 6), (0, 9),
        (1, 2), (1, 5), (1, 7),
        (2, 3), (2, 6), (2, 8),
        (3, 4), (3, 7), (3, 9),
        (4, 5), (4, 8),
        (5, 10), (5, 11),
        (6, 10), (6, 11),
        (7, 8), (7, 11),
        (8, 10),
        (9, 10), (9, 11),
    ]
    return from_edges(12, edges, "(12,4)-Chvatal")


_CHVATAL32_EDGES = (
    (0, 10), (0, 16), (0, 19), (0, 20), (1, 8), (1, 11), (1, 18), (1, 21),
    (2, 5), (2, 13), (2, 27), (2, 31), (3, 14), (3, 16), (3, 25), (3, 30),
    (4, 6), (4, 8), (4, 24), (4, 26), (5, 6), (5, 10), (5, 28), (6, 9),
    (6, 17), (7, 8), (7, 9), (7, 11), (7, 22), (8, 30), (9, 22), (9, 30),
    (10, 29), (10, 31), (11, 12), (11, 29), (12, 21), (12, 23), (12, 24),
    (13, 14), (13, 25), (13, 29), (14, 15), (14, 23), (15, 20), (15, 21),
    (15, 31), (16, 19), (16, 26), (17, 22), (17, 23), (17, 27), (18, 23),
    (18, 24), (18, 30), (19, 28), (19, 31), (20, 22), (20, 26), (21, 27),
    (24, 27), (25, 28), (25, 29), (26, 28),
)


def chvatal32() -> Graph:
    """32-vertex degree-4 'Chvatal' as used by the paper (D=4, MPL=2.55, BW=8).

    The paper does not publish the edge list.  No 4-regular circulant on 32
    vertices reaches MPL < 2.70, so the paper's graph is not circulant; we
    reconstructed one by annealing edge swaps away from the 4x8 torus (which
    pins the BW=8 cut structure) until the published invariants are matched
    exactly: D=4, MPL=2532/992=2.5524 (paper rounds 2.55), BW=8.  The edge
    list is frozen here for bit-reproducibility and asserted in tests.
    """
    return from_edges(32, _CHVATAL32_EDGES, "(32,4)-Chvatal")


def petersen() -> Graph:
    edges = [(i, (i + 1) % 5) for i in range(5)]
    edges += [(i + 5, (i + 2) % 5 + 5) for i in range(5)]
    edges += [(i, i + 5) for i in range(5)]
    return from_edges(10, edges, "Petersen")


def torus(dims: Sequence[int]) -> Graph:
    """k-ary n-cube torus with wraparound in every dimension.

    Dimensions of size 2 contribute degree 1 on that axis (the wrap edge
    coincides with the mesh edge); size 1 axes are ignored.  ``torus([4,4])``
    is the paper's (16,4)-Torus (= 4D hypercube), ``torus([4,8])`` the 32-node
    torus, ``torus([16,16])``, ``torus([4,8,8])``, ``torus([4,4,4,4])`` the
    256-node variants of TABLE 4.
    """
    dims = [d for d in dims if d > 1]
    n = int(np.prod(dims))
    strides = np.cumprod([1] + list(dims[:-1]))

    def idx(coord):
        return int(sum(c * s for c, s in zip(coord, strides)))

    edges = set()
    for coord in itertools.product(*[range(d) for d in dims]):
        for axis, d in enumerate(dims):
            nb = list(coord)
            nb[axis] = (coord[axis] + 1) % d
            e = (idx(coord), idx(tuple(nb)))
            if e[0] != e[1]:
                edges.add((min(e), max(e)))
    name = f"({n},{_torus_degree(dims)})-Torus{'x'.join(map(str, dims))}"
    return from_edges(n, edges, name)


def _torus_degree(dims: Sequence[int]) -> int:
    return sum(1 if d == 2 else 2 for d in dims if d > 1)


def hypercube(dim: int) -> Graph:
    n = 1 << dim
    edges = []
    for u in range(n):
        for b in range(dim):
            v = u ^ (1 << b)
            if u < v:
                edges.append((u, v))
    return from_edges(n, edges, f"Q{dim}")


def dragonfly(a: int, g: int | None = None, h: int = 1) -> Graph:
    """Canonical Dragonfly (Kim et al. 2008) at router granularity.

    ``a`` routers per group, each group a clique; ``h`` global links per
    router; ``g`` groups (default a*h + 1, the maximal balanced size).  Global
    link l of the whole system connects group pairs in the standard palmtree
    arrangement.  Node degree = (a-1) intra + h global = the paper's k.

    Paper instances: (20,4)-Dragonfly = a=4,g=5,h=1; (30,5)-Dragonfly =
    a=5,g=6,h=1; (36,5)-Dragonfly a=... the paper's 36-node degree-5 uses
    a=4,g=9? Degree = a-1+h: for (36,5): a=5 would give 5-1+1=5 with g=36/5
    non-integer — instead a=4,h=2,g=9: degree 3+2=5, n=36.  We expose all
    three parameters and pin the paper's instances in configs/tests.
    """
    if g is None:
        g = a * h + 1
    n = a * g
    edges = set()
    # intra-group cliques
    for gi in range(g):
        base = gi * a
        for i, j in itertools.combinations(range(a), 2):
            edges.add((base + i, base + j))
    # global links: palmtree/consecutive allocation. Each group has a*h global
    # endpoints; endpoint e of group gi connects to group (gi + e + 1) mod g.
    # Pair endpoints symmetrically so each link is used once.
    ge = a * h  # global endpoints per group
    for gi in range(g):
        for e in range(ge):
            gj = (gi + e + 1) % g
            if gj == gi:
                continue
            # router within group: endpoint e maps to router e % a, its h-th port
            u = gi * a + (e % a)
            # reciprocal endpoint in gj that points back to gi:
            eb = (gi - gj - 1) % g
            # map reciprocal endpoint index into [0, ge)
            if eb >= ge:
                continue
            v = gj * a + (eb % a)
            if u != v:
                edges.add((min(u, v), max(u, v)))
    gph = from_edges(n, edges, f"({n},{a - 1 + h})-Dragonfly(a={a},g={g},h={h})")
    return gph


# --------------------------------------------------------------------------------
# Random regular graphs (SA starting points)
# --------------------------------------------------------------------------------

def random_regular(n: int, k: int, seed: int = 0, max_tries: int = 200) -> Graph:
    """Uniform-ish random k-regular graph via pairing model with retries."""
    if n * k % 2:
        raise ValueError("n*k must be even")
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        stubs = np.repeat(np.arange(n), k)
        rng.shuffle(stubs)
        pairs = stubs.reshape(-1, 2)
        edges = {(min(u, v), max(u, v)) for u, v in pairs}
        if len(edges) != len(pairs):
            continue
        if any(u == v for u, v in edges):
            continue
        g = from_edges(n, edges, f"({n},{k})-Random")
        if g.is_regular() and g.degree() == k:
            return g
    raise RuntimeError(f"failed to sample random {k}-regular graph on {n} vertices")


def random_hamiltonian_regular(n: int, k: int, seed: int = 0, max_tries: int = 500) -> Graph:
    """Random k-regular graph containing the ring 0-1-...-n-1-0.

    This is the paper's SA starting point: an embedded Hamiltonian ring (so
    the physical layout is a ring of racks + chords) plus a random perfect
    set of chords bringing every vertex to degree k.
    """
    if k < 2:
        raise ValueError("need k >= 2")
    if n * (k - 2) % 2:
        raise ValueError("n*(k-2) must be even")
    rng = np.random.default_rng(seed)
    ring_edges = {(i, (i + 1) % n) for i in range(n - 1)} | {(0, n - 1)}
    extra = k - 2
    for _ in range(max_tries):
        stubs = np.repeat(np.arange(n), extra)
        rng.shuffle(stubs)
        pairs = stubs.reshape(-1, 2)
        chords = set()
        ok = True
        for u, v in pairs:
            u, v = int(u), int(v)
            e = (min(u, v), max(u, v))
            if u == v or e in ring_edges or e in chords:
                ok = False
                break
            chords.add(e)
        if not ok:
            continue
        g = from_edges(n, ring_edges | chords, f"({n},{k})-RandomHam")
        if g.is_regular() and g.degree() == k:
            return g
    raise RuntimeError(f"failed to sample Hamiltonian {k}-regular graph on {n} vertices")


# --------------------------------------------------------------------------------
# Nested / hierarchical composition (cluster-hub networks)
# --------------------------------------------------------------------------------

def nested_compose(outer: Graph, inner: Graph, hub: int = 0,
                   name: str | None = None) -> Graph:
    """Hierarchical composition: one ``inner`` copy per ``outer`` vertex.

    Every vertex of ``outer`` is replaced by a full copy of ``inner``
    (vertices of copy i live at ``i*inner.n + j``); every outer edge
    (a, b) becomes a single link between the ``hub`` vertex of copy a and
    the ``hub`` vertex of copy b.  This is the cluster-hub pattern of
    nested interconnection networks (each cluster talks to the backbone
    through one gateway router), and is generally *irregular*: hubs carry
    inner-degree + outer-degree.
    """
    if inner.n < 1:
        raise ValueError("inner graph must have at least one vertex")
    if not 0 <= hub < inner.n:
        raise ValueError(f"hub={hub} out of range for inner n={inner.n}")
    b = inner.n
    edges: list[tuple[int, int]] = []
    for i in range(outer.n):
        edges.extend((i * b + u, i * b + v) for u, v in inner.edges)
    edges.extend((a * b + hub, c * b + hub) for a, c in outer.edges)
    n = outer.n * b
    return from_edges(
        n, edges, name or f"({n})-Nested[{outer.name}*{inner.name}]")


_CLUSTER_HUB_PARTS = {"ring": ring, "complete": complete}


def _hub_part(kind: str, n: int) -> Graph:
    try:
        fn = _CLUSTER_HUB_PARTS[kind]
    except KeyError:
        raise ValueError(
            f"cluster_hub part {kind!r}; known: {sorted(_CLUSTER_HUB_PARTS)}"
        ) from None
    if fn is ring and n < 3:  # degenerate ring == path == complete for n<=2
        fn = complete
    return fn(n)


def cluster_hub(clusters: int, size: int, inner: str = "complete",
                outer: str = "ring") -> Graph:
    """Cluster-hub network: ``clusters`` clusters of ``size`` nodes each.

    Each cluster is internally wired as ``inner`` ("complete" or "ring");
    node 0 of each cluster is its hub/gateway, and the hubs are wired as
    ``outer`` across clusters.  ``cluster_hub(4, 8)`` is 4 fully-connected
    8-node clusters on a hub ring — the Cluster3D_Hub shape.
    """
    if clusters < 2:
        raise ValueError("cluster_hub needs at least 2 clusters")
    if size < 1:
        raise ValueError("cluster_hub needs size >= 1")
    g = nested_compose(_hub_part(outer, clusters), _hub_part(inner, size))
    return g.with_name(
        f"({g.n})-ClusterHub({clusters}x{size},{inner},{outer})")


def build(spec: str, device=None, **kw) -> Graph:
    """Deprecated shim: build a topology from a string spec.

    Use ``repro_torch.api.build_topology`` (or ``core.topologies``) instead —
    this delegates there, so the grammar (``ring:16``, ``torus:4x8``,
    ``wagner:32``, ``circulant:32:1,7``, ``dragonfly:4,5,1``,
    ``optimal:16,3``) and the resulting graphs are the reference's.
    ``device`` is where a searched family prices.
    """
    import warnings

    warnings.warn(
        "graphs.build is deprecated: use repro_torch.api.build_topology (a "
        "TopologySpec or the same 'family:args' string)",
        DeprecationWarning, stacklevel=2)
    from . import topologies  # lazy: topologies imports this module

    return topologies.build_topology(spec, device, **kw)


REGISTRY = {
    "ring": ring,
    "wagner": wagner,
    "bidiakis": bidiakis,
    "chvatal": chvatal,
    "chvatal32": chvatal32,
    "petersen": petersen,
    "circulant": circulant,
    "torus": torus,
    "hypercube": hypercube,
    "dragonfly": dragonfly,
    "complete": complete,
    "random_regular": random_regular,
    "random_hamiltonian_regular": random_hamiltonian_regular,
}
