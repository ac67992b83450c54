"""The port's routing, Hamiltonian and traffic modules
(``repro_torch.core.routing``, ``hamiltonian``, ``traffic``) against the
JAX package's, on the CPU.

All three are host numpy copies of the reference's, so every value must be
equal (``==``): the static table's distances and next hops (Floyd–Warshall
with the reference's strict ``<``), paths, minimal candidates and link
loads, the adaptive tier's loads and EWMA state, the Hamiltonian cycles and
the seeded traffic generators.  Graphs: Table 1's named topologies and the
256-node torus of Table 4.
"""
import numpy as np
import pytest

from repro.core import graphs as ref_graphs
from repro.core import hamiltonian as ref_ham
from repro.core import metrics as ref_metrics
from repro.core import routing as ref_routing
from repro.core import traffic as ref_traffic
from repro_torch.core import graphs, hamiltonian, metrics, routing, traffic

# Table 1's named graphs (tests/test_golden.py) and Table 4's (256,4)-Torus
NAMED = [
    ("ring-16", "ring", (16,)),
    ("wagner-16", "wagner", (16,)),
    ("bidiakis-16", "bidiakis", (16,)),
    ("torus-4x4", "torus", ([4, 4],)),
    ("ring-32", "ring", (32,)),
    ("wagner-32", "wagner", (32,)),
    ("bidiakis-32", "bidiakis", (32,)),
    ("torus-4x8", "torus", ([4, 8],)),
    ("chvatal32", "chvatal32", ()),
    ("chvatal", "chvatal", ()),
    ("bidiakis-12", "bidiakis", (12,)),
    ("dragonfly-4-5-1", "dragonfly", (4, 5, 1)),
    ("dragonfly-5-6-1", "dragonfly", (5, 6, 1)),
    ("dragonfly-4-9-2", "dragonfly", (4, 9, 2)),
    ("torus-16x16", "torus", ([16, 16],)),
]
IDS = [c[0] for c in NAMED]


def _pair(case):
    _, fn, args = case
    return getattr(graphs, fn)(*args), getattr(ref_graphs, fn)(*args)


def _tables(case):
    g, h = _pair(case)
    return routing.RoutingTable.build(g), ref_routing.RoutingTable.build(h)


def _flows(n, seed, count=48):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, count)
    dst = rng.integers(0, n, count)
    return [(int(s), int(d), float(b))
            for s, d, b in zip(src, dst, rng.integers(1, 5000, count))]


@pytest.mark.parametrize("case", NAMED, ids=IDS)
def test_static_table_equals_reference(case):
    rt, ref = _tables(case)
    n = rt.graph.n
    assert np.array_equal(rt.dist, ref.dist) and np.array_equal(rt.next_hop, ref.next_hop)
    assert np.array_equal(rt.neighbor_table(), ref.neighbor_table())
    rng = np.random.default_rng(n)
    pairs = [(int(u), int(v)) for u, v in rng.integers(0, n, (40, 2))]
    for u, v in pairs:
        assert rt.path(u, v) == ref.path(u, v)
        assert rt.path_links(u, v) == ref.path_links(u, v)
        assert rt.candidates(u, v) == ref.candidates(u, v)
    nodes, dsts = np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])
    assert np.array_equal(rt.candidate_slots(nodes, dsts), ref.candidate_slots(nodes, dsts))
    flows = _flows(n, 1)
    assert rt.link_loads(flows) == ref.link_loads(flows)
    assert rt.max_congestion(flows) == ref.max_congestion(flows)
    assert rt.mean_hops(flows) == ref.mean_hops(flows) and rt.mean_hops() == ref.mean_hops()
    if n <= 36:  # the all-to-all default: n^2 paths
        assert rt.link_loads() == ref.link_loads()


@pytest.mark.parametrize("case", NAMED, ids=IDS)
@pytest.mark.parametrize("config", [
    dict(),
    dict(gamma=0.0),
    dict(gamma=2.0, ewma=0.25, lookahead=0.0, chunk=7),
], ids=["default", "static", "tuned"])
def test_adaptive_link_loads_equal_reference(case, config):
    rt, ref = _tables(case)
    flows = _flows(rt.graph.n, 2, count=96 if rt.graph.n <= 36 else 400)
    got, got_state = routing.adaptive_link_loads(rt, flows, routing.AdaptiveConfig(**config))
    want, want_state = ref_routing.adaptive_link_loads(
        ref, flows, ref_routing.AdaptiveConfig(**config))
    assert np.array_equal(got, want) and np.array_equal(got_state, want_state)
    # a second round carries the EWMA state
    got2, _ = routing.adaptive_link_loads(rt, flows, routing.AdaptiveConfig(**config),
                                          got_state)
    want2, _ = ref_routing.adaptive_link_loads(ref, flows, ref_routing.AdaptiveConfig(**config),
                                               want_state)
    assert np.array_equal(got2, want2)
    assert routing.loads_to_dict(rt, got) == ref_routing.loads_to_dict(ref, want)


def test_adaptive_refuses_disconnected_flows_as_reference():
    edges = [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5)]
    rt = routing.RoutingTable.build(graphs.from_edges(6, edges, "two-triangles"))
    ref = ref_routing.RoutingTable.build(ref_graphs.from_edges(6, edges, "two-triangles"))
    for mod, table in ((routing, rt), (ref_routing, ref)):
        with pytest.raises(ValueError, match="unreachable"):
            mod.adaptive_link_loads(table, [(0, 4, 1.0)])
    with pytest.raises(ValueError, match="no route"):
        rt.path(0, 4)


@pytest.mark.parametrize("case", NAMED[:-1], ids=IDS[:-1])
def test_edge_betweenness_proxy_reads_the_routing_table(case):
    g, h = _pair(case)
    got = metrics.edge_betweenness_proxy(g)
    assert got == ref_metrics.edge_betweenness_proxy(h)
    assert got == routing.RoutingTable.build(g).link_loads()


@pytest.mark.parametrize("case", NAMED + [
    ("petersen", "petersen", ()),
    ("hypercube-4", "hypercube", (4,)),
    ("random-regular-20-3", "random_regular", (20, 3)),
], ids=IDS + ["petersen", "hypercube-4", "random-regular-20-3"])
def test_hamiltonian_cycle_equals_reference(case):
    g, h = _pair(case)
    assert hamiltonian.has_embedded_ring(g) == ref_ham.has_embedded_ring(h)
    for budget in (50, 100_000):  # 100_000: the budget schedules give it
        assert hamiltonian.hamiltonian_cycle(g, budget=budget) == \
            ref_ham.hamiltonian_cycle(h, budget=budget)


@pytest.mark.parametrize("dims", [[4, 4], [4, 8], [16, 16], [4, 8, 8], [2, 1, 6]])
def test_torus_hamiltonian_equals_reference(dims):
    order = hamiltonian.torus_hamiltonian(dims)
    assert order == ref_ham.torus_hamiltonian(dims)
    assert sorted(order) == list(range(int(np.prod(dims))))


@pytest.mark.parametrize("name,n,kw", [
    ("uniform", 16, {}), ("uniform", 256, {}),
    ("random-perm", 32, {}), ("random-perm", 256, {}),
    ("transpose", 16, {}), ("transpose", 32, {}), ("transpose", 256, {}),
    ("shift", 30, {}), ("shift", 256, {"stride": 17}), ("shift", 8, {"stride": 8}),
    ("hotspot", 32, {}), ("hotspot", 256, {"hot": 4, "frac": 0.8}),
])
def test_traffic_patterns_equal_reference(name, n, kw):
    assert traffic.traffic_patterns() == ref_traffic.traffic_patterns()
    for seed in (0, 7):
        assert traffic.traffic_pattern(name, n, seed=seed, **kw) == \
            ref_traffic.traffic_pattern(name, n, seed=seed, **kw)


def test_traffic_refusals_equal_reference():
    for mod in (traffic, ref_traffic):
        with pytest.raises(ValueError, match="unknown traffic pattern"):
            mod.traffic_pattern("tornado", 16)
        with pytest.raises(ValueError, match="square or power-of-two"):
            mod.traffic_pattern("transpose", 12)
        with pytest.raises(ValueError, match="frac"):
            mod.traffic_pattern("hotspot", 16, frac=1.5)
        assert mod.traffic_pattern("uniform", 1) == []
