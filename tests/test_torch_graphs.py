"""The port's topology constructors and graph invariants
(``repro_torch.core.graphs`` and ``repro_torch.core.metrics``) against the
JAX package's, on the CPU.

Constructors, girth, bisection width (exact at n <= 20, Kernighan–Lin from
the same seeded starts above), the routing proxy and ``stats`` are host
numpy copies: every value must be equal.  ``apsp_hops``/``apsp`` sweep every
source through the BFS sweep kernel's plain PyTorch version
(``device="cpu"``) and must equal the reference's dense matmul BFS, the
unreachable sentinel included.  The golden rows are the integers of
``tests/test_golden.py``, recomputed through the port.
"""
import numpy as np
import pytest
import torch

from repro.core import graphs as ref_graphs
from repro.core import metrics as ref_metrics
from repro_torch.core import graphs, metrics

# (id, constructor name, args, kwargs): every constructor of the registry
# and the composition helpers, at the paper's sizes and a few others
CONSTRUCTORS = [
    ("ring-16", "ring", (16,), {}),
    ("complete-7", "complete", (7,), {}),
    ("circulant-40", "circulant", (40, [1, 7, 20]), {}),
    ("wagner-16", "wagner", (16,), {}),
    ("wagner-32", "wagner", (32,), {}),
    ("bidiakis-12", "bidiakis", (12,), {}),
    ("bidiakis-16", "bidiakis", (16,), {}),
    ("bidiakis-32", "bidiakis", (32,), {}),
    ("bidiakis-256", "bidiakis", (256,), {}),
    ("chvatal", "chvatal", (), {}),
    ("chvatal32", "chvatal32", (), {}),
    ("petersen", "petersen", (), {}),
    ("torus-4x4", "torus", ([4, 4],), {}),
    ("torus-4x8", "torus", ([4, 8],), {}),
    ("torus-2x3x1x4", "torus", ([2, 3, 1, 4],), {}),
    ("torus-4x4x4x4", "torus", ([4, 4, 4, 4],), {}),
    ("hypercube-5", "hypercube", (5,), {}),
    ("dragonfly-4-5-1", "dragonfly", (4, 5, 1), {}),
    ("dragonfly-5-6-1", "dragonfly", (5, 6, 1), {}),
    ("dragonfly-4-9-2", "dragonfly", (4, 9, 2), {}),
    ("dragonfly-3-default-g", "dragonfly", (3,), {"h": 2}),
    ("random-regular", "random_regular", (20, 3), {"seed": 5}),
    ("random-ham-16-4", "random_hamiltonian_regular", (16, 4), {"seed": [0, 1]}),
    ("random-ham-30-5", "random_hamiltonian_regular", (30, 5),
     {"seed": [0, 1], "max_tries": 20000}),
    ("cluster-hub-4x8", "cluster_hub", (4, 8), {}),
    ("cluster-hub-3x5-ring-complete", "cluster_hub", (3, 5, "ring", "complete")),
    ("cluster-hub-2x2", "cluster_hub", (2, 2), {}),
]


def _build(mod, name, args, kw=None):
    return getattr(mod, name)(*args, **(kw or {}))


@pytest.mark.parametrize("case", CONSTRUCTORS, ids=[c[0] for c in CONSTRUCTORS])
def test_constructor_edges_equal_reference(case):
    _, name, args, *kw = case
    got = _build(graphs, name, args, *kw)
    want = _build(ref_graphs, name, args, *kw)
    assert (got.n, got.edges, got.name) == (want.n, want.edges, want.name)
    assert got.is_regular() == want.is_regular()
    assert np.array_equal(got.degrees(), want.degrees())


def test_registry_and_composition_equal_reference():
    assert graphs.REGISTRY.keys() == ref_graphs.REGISTRY.keys()
    outer, inner = graphs.ring(5), graphs.petersen()
    got = graphs.nested_compose(outer, inner, hub=3)
    want = ref_graphs.nested_compose(ref_graphs.ring(5), ref_graphs.petersen(), hub=3)
    assert (got.n, got.edges, got.name) == (want.n, want.edges, want.name)
    # the same refusals as the reference
    for name, args in [("wagner", (15,)), ("bidiakis", (20,)), ("ring", (2,)),
                       ("random_regular", (7, 3)), ("random_hamiltonian_regular", (9, 3)),
                       ("cluster_hub", (1, 4))]:
        with pytest.raises(ValueError):
            _build(ref_graphs, name, args)
        with pytest.raises(ValueError):
            _build(graphs, name, args)
    with pytest.raises(ValueError, match="cluster_hub part"):
        graphs.cluster_hub(3, 4, inner="star")


# constructor, n, k, diameter, exact_total_hops, paper_mpl_2dp, bisection_width
# (the rows of tests/test_golden.py)
GOLDEN = [
    ("(16,2)-Ring", lambda: graphs.ring(16), 16, 2, 8, 1024, 4.27, 2),
    ("(16,3)-Wagner", lambda: graphs.wagner(16), 16, 3, 4, 624, 2.60, 4),
    ("(16,3)-Bidiakis", lambda: graphs.bidiakis(16), 16, 3, 5, 608, 2.53, 4),
    ("(16,4)-Torus", lambda: graphs.torus([4, 4]), 16, 4, 4, 512, 2.13, 8),
    ("(32,2)-Ring", lambda: graphs.ring(32), 32, 2, 16, 8192, 8.26, 2),
    ("(32,3)-Wagner", lambda: graphs.wagner(32), 32, 3, 8, 4576, 4.61, 4),
    ("(32,3)-Bidiakis", lambda: graphs.bidiakis(32), 32, 3, 9, 4032, 4.06, 4),
    ("(32,4)-Torus", lambda: graphs.torus([4, 8]), 32, 4, 6, 3072, 3.10, 8),
    ("(32,4)-Chvatal", lambda: graphs.chvatal32(), 32, 4, 4, 2532, 2.55, 8),
    ("(12,4)-Chvatal", graphs.chvatal, 12, 4, 2, 216, 1.64, 8),
    ("(12,3)-Bidiakis", lambda: graphs.bidiakis(12), 12, 3, 3, 268, 2.03, 4),
    ("(20,4)-Dragonfly", lambda: graphs.dragonfly(4, 5, 1), 20, 4, 3, 860, 2.26, 8),
    ("(30,5)-Dragonfly", lambda: graphs.dragonfly(5, 6, 1), 30, 5, 3, 2070, 2.38, 9),
    ("(36,5)-Dragonfly", lambda: graphs.dragonfly(4, 9, 2), 36, 5, 3, 2952, 2.34, 20),
]


@pytest.mark.parametrize("make,n,k,D,total,paper_mpl,bw",
                         [row[1:] for row in GOLDEN], ids=[row[0] for row in GOLDEN])
def test_golden_invariants_through_the_port(make, n, k, D, total, paper_mpl, bw):
    g = make()
    assert g.n == n and g.is_regular() and g.degree() == k
    d = metrics.apsp(g, device="cpu")
    assert int(d[~np.eye(n, dtype=bool)].sum()) == total
    assert metrics.diameter(g, d) == D
    assert round(total / (n * (n - 1)), 2) == pytest.approx(paper_mpl, abs=1e-9)
    assert metrics.mpl(g, d) == total / (n * (n - 1))
    assert metrics.is_connected(g, d)
    assert np.array_equal(metrics.eccentricities(g, d), ref_metrics.eccentricities(g, d))
    assert metrics.bisection_width(g, restarts=24, seed=0) == bw


def _disconnected():
    # two 4-cycles and an isolated vertex
    return graphs.from_edges(9, [(0, 1), (1, 2), (2, 3), (3, 0),
                                 (4, 5), (5, 6), (6, 7), (7, 4)], "split")


APSP_CASES = [
    ("petersen", graphs.petersen),
    ("bidiakis-32", lambda: graphs.bidiakis(32)),
    ("random-ham-40-5", lambda: graphs.random_hamiltonian_regular(40, 5, seed=2, max_tries=20000)),
    ("cluster-hub-4x8", lambda: graphs.cluster_hub(4, 8)),
    ("ring-70", lambda: graphs.ring(70)),  # 35 levels: past the kernel's bit-planes
    ("disconnected", _disconnected),
]


@pytest.mark.parametrize("build", [c[1] for c in APSP_CASES], ids=[c[0] for c in APSP_CASES])
def test_apsp_on_the_sweep_equals_reference(build):
    g = build()
    adj = g.adjacency()
    got = metrics.apsp_hops(adj, device="cpu")
    want = ref_metrics.apsp_hops(adj)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(metrics.apsp_hops(adj, 1000, device="cpu"),
                          ref_metrics.apsp_hops(adj, 1000))
    d = metrics.apsp(g, device="cpu")
    assert np.array_equal(d, ref_metrics.apsp(g))
    rd = ref_metrics.apsp(g)
    assert metrics.is_connected(g, device="cpu") == ref_metrics.is_connected(g)
    assert metrics.mpl(g, device="cpu") == ref_metrics.mpl(g, rd)
    assert metrics.diameter(g, device="cpu") == ref_metrics.diameter(g, rd)
    assert np.array_equal(metrics.eccentricities(g, device="cpu"),
                          ref_metrics.eccentricities(g, rd))


def test_invariants_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = graphs.petersen()
    for call in (lambda: metrics.apsp_hops(g.adjacency()), lambda: metrics.apsp(g),
                 lambda: metrics.mpl(g), lambda: metrics.diameter(g),
                 lambda: metrics.is_connected(g), lambda: metrics.stats(g)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # a given dist needs no device
    assert metrics.mpl(g, metrics.apsp(g, device="cpu")) == ref_metrics.mpl(g)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_apsp_refuses_graphs_past_the_sweep(device):
    """Above MAX_SWEEP_N vertices the all-source sweep is refused on every
    device before any work, never handed to another BFS."""
    from repro_torch.kernels import bfs_sweep
    n = bfs_sweep.MAX_SWEEP_N + 1
    adj = np.zeros((n, n), dtype=bool)  # zero pages: never touched
    with pytest.raises(ValueError, match="MAX_SWEEP_N"):
        metrics.apsp_hops(adj, device=device)


HOST_CASES = [
    ("petersen", lambda m: m.petersen()),
    ("chvatal32", lambda m: m.chvatal32()),
    ("dragonfly-4-9-2", lambda m: m.dragonfly(4, 9, 2)),
    ("cluster-hub-3x5", lambda m: m.cluster_hub(3, 5, "ring", "ring")),
    ("torus-4x8", lambda m: m.torus([4, 8])),
    ("random-ham-32-3", lambda m: m.random_hamiltonian_regular(32, 3, seed=4)),
]


@pytest.mark.parametrize("build", [c[1] for c in HOST_CASES], ids=[c[0] for c in HOST_CASES])
def test_host_invariants_equal_reference(build):
    g, h = build(graphs), build(ref_graphs)
    assert metrics.girth(g) == ref_metrics.girth(h)
    for restarts, seed in ((24, 0), (3, 7)):
        assert metrics.bisection_width(g, restarts=restarts, seed=seed) == \
            ref_metrics.bisection_width(h, restarts=restarts, seed=seed)
    assert metrics.bisection_width(g, exact_limit=0, restarts=2) == \
        ref_metrics.bisection_width(h, exact_limit=0, restarts=2)
    got = metrics.edge_betweenness_proxy(g)
    want = ref_metrics.edge_betweenness_proxy(h)
    assert got == want and list(got) == list(want)
    st, rs = metrics.stats(g, bw_restarts=4, seed=1, device="cpu"), \
        ref_metrics.stats(h, bw_restarts=4, seed=1)
    for f in ref_metrics.GraphStats.__slots__:
        assert getattr(st, f) == getattr(rs, f), f
    assert st.row() == rs.row()


def test_girth_of_a_forest_and_bounds():
    tree = graphs.from_edges(5, [(0, 1), (1, 2), (1, 3), (3, 4)], "tree")
    assert metrics.girth(tree) == ref_metrics.girth(
        ref_graphs.from_edges(5, [(0, 1), (1, 2), (1, 3), (3, 4)])) == float("inf")
    for n, k, d in [(16, 3, 2), (36, 5, 3), (1000, 4, 6)]:
        assert metrics.moore_bound_vertices(k, d) == ref_metrics.moore_bound_vertices(k, d)
