"""The port's simulated cluster (``repro_torch.core.collectives``,
``repro_torch.comm.schedules``, ``repro_torch.core.netsim``) against the
JAX package's, on the CPU.

All three are host numpy copies with the reference's operations in the
reference's order, so every report and every benchmark time must be equal
(``==``): each rank-space schedule and its price under both routing tiers,
each synthesized schedule and its numeric execution, and every netsim
benchmark on Table 1's graphs (n <= 32) and on Table 4's 256-node torus.
"""
import dataclasses

import numpy as np
import pytest

from repro.comm import schedules as ref_schedules
from repro.core import collectives as ref_C
from repro.core import graphs as ref_graphs
from repro.core import netsim as ref_netsim
from repro.core import routing as ref_routing
from repro_torch.comm import schedules
from repro_torch.core import collectives as C
from repro_torch.core import graphs, netsim, routing

SMALL = [("ring-16", "ring", (16,)), ("wagner-16", "wagner", (16,)),
         ("torus-4x4", "torus", ([4, 4],)), ("chvatal32", "chvatal32", ()),
         ("dragonfly-4-5-1", "dragonfly", (4, 5, 1)), ("petersen", "petersen", ()),
         ("bidiakis-32", "bidiakis", (32,))]
SMALL_IDS = [c[0] for c in SMALL]
ADAPTIVE = dict(gamma=4.0, ewma=0.3, lookahead=0.25, chunk=16)


def _pair(case):
    _, fn, args = case
    return getattr(graphs, fn)(*args), getattr(ref_graphs, fn)(*args)


def _report(rep):
    return dataclasses.astuple(rep)


@pytest.mark.parametrize("n", [2, 7, 16, 32])
@pytest.mark.parametrize("op", sorted(C.ALGORITHMS))
def test_rank_schedules_equal_reference(op, n):
    assert sorted(C.ALGORITHMS) == sorted(ref_C.ALGORITHMS)
    assert C.default_allreduce(n) == ref_C.default_allreduce(n)
    kw = {"root": 3 % n} if op in ("bcast", "reduce", "scatter", "gather") else {}
    if op == "allreduce_recdbl" and n & (n - 1):
        for fn in (C.ALGORITHMS[op], ref_C.ALGORITHMS[op]):
            with pytest.raises(ValueError, match="power-of-two"):
                fn(n, 1024.0)
        return
    got, want = C.ALGORITHMS[op](n, 1000.0, **kw), ref_C.ALGORITHMS[op](n, 1000.0, **kw)
    assert (got.name, got.n) == (want.name, want.n)
    assert [[dataclasses.astuple(t) for t in r] for r in got.rounds] == \
        [[dataclasses.astuple(t) for t in r] for r in want.rounds]
    assert got.total_bytes() == want.total_bytes()


@pytest.mark.parametrize("case", SMALL[:-1], ids=SMALL_IDS[:-1])
@pytest.mark.parametrize("routing_tier", ["static", "adaptive", "adaptive-gamma0"])
def test_simulate_and_collective_time_equal_reference(case, routing_tier):
    g, h = _pair(case)
    rt, ref_rt = routing.RoutingTable.build(g), ref_routing.RoutingTable.build(h)
    tier = "static" if routing_tier == "static" else "adaptive"
    cfg = dict(ADAPTIVE, gamma=0.0) if routing_tier == "adaptive-gamma0" else ADAPTIVE
    kw = dict(routing=tier, adaptive=routing.AdaptiveConfig(**cfg))
    ref_kw = dict(routing=tier, adaptive=ref_routing.AdaptiveConfig(**cfg))
    flood, ref_flood = C.bcast_flood(g.n, 512.0, g, root=1), \
        ref_C.bcast_flood(h.n, 512.0, h, root=1)
    assert _report(C.simulate(flood, rt, C.TAISHAN_LINK, **kw)) == \
        _report(ref_C.simulate(ref_flood, ref_rt, ref_C.TAISHAN_LINK, **ref_kw))
    for op in ("bcast", "scatter", "allreduce", "alltoall", "alltoall_direct"):
        for model, ref_model in ((C.TAISHAN_LINK, ref_C.TAISHAN_LINK),
                                 (C.TPU_ICI_LINK, ref_C.TPU_ICI_LINK)):
            assert _report(C.collective_time(g, op, 4096.0, model, rt, **kw)) == \
                _report(ref_C.collective_time(h, op, 4096.0, ref_model, ref_rt, **ref_kw))


def test_simulate_refusals_equal_reference():
    g, h = graphs.ring(8), ref_graphs.ring(8)
    for mod, gg in ((C, g), (ref_C, h)):
        rt = (routing if mod is C else ref_routing).RoutingTable.build(gg)
        with pytest.raises(ValueError, match="routing="):
            mod.simulate(mod.bcast_binomial(8, 1.0), rt, mod.TAISHAN_LINK, routing="valiant")
        with pytest.raises(ValueError, match="self transfer"):
            mod.simulate(mod.Schedule("bad", 8, [[mod.Transfer(2, 2, 1.0)]]), rt,
                         mod.TAISHAN_LINK)


@pytest.mark.parametrize("case", SMALL, ids=SMALL_IDS)
@pytest.mark.parametrize("op", sorted(schedules.SYNTH_OPS))
def test_synthesize_equals_reference(case, op):
    assert schedules.SYNTH_OPS == ref_schedules.SYNTH_OPS
    g, h = _pair(case)
    got = schedules.synthesize(g, op, 65536.0, root=2)
    want = ref_schedules.synthesize(h, op, 65536.0, root=2)
    assert (got.op, got.algorithm, got.candidates, got.order) == \
        (want.op, want.algorithm, want.candidates, want.order)
    assert dataclasses.astuple(got.report) == dataclasses.astuple(want.report)
    assert [[dataclasses.astuple(t) for t in r] for r in got.schedule.rounds] == \
        [[dataclasses.astuple(t) for t in r] for r in want.schedule.rounds]
    assert (got.tree is None) == (want.tree is None)
    if got.tree is not None:
        assert dataclasses.astuple(got.tree) == dataclasses.astuple(want.tree)
    assert _report(schedules.synthesized_time(g, op, 1024.0)) == \
        _report(ref_schedules.synthesized_time(h, op, 1024.0))
    if op == "allreduce":
        values = np.random.default_rng(g.n).integers(-50, 50, (g.n, 3 * g.n + 1))
        out = schedules.execute_allreduce(got, values)
        assert np.array_equal(out, ref_schedules.execute_allreduce(want, values))
        assert np.array_equal(out, np.broadcast_to(values.sum(axis=0), values.shape))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_allreduce_candidates_equal_reference(n):
    for g, h in ((graphs.hypercube(int(np.log2(n))), ref_graphs.hypercube(int(np.log2(n)))),
                 (graphs.ring(n), ref_graphs.ring(n))):
        got = schedules.allreduce_candidates(g, 4096.0, cycle_budget=1000)
        want = ref_schedules.allreduce_candidates(h, 4096.0, cycle_budget=1000)
        assert list(got) == list(want)
        for name in got:
            assert [[dataclasses.astuple(t) for t in r] for r in got[name][0].rounds] == \
                [[dataclasses.astuple(t) for t in r] for r in want[name][0].rounds]
        hd = schedules.halving_doubling_allreduce(n, 8.0 * n)
        for algo, meta in (("halving-doubling", {}), ("ring", {"order": tuple(range(n))})):
            syn = schedules.SynthesizedCollective("allreduce", algo, hd, None, {},
                                                  order=meta.get("order"))
            ref_syn = ref_schedules.SynthesizedCollective("allreduce", algo, hd, None, {},
                                                          order=meta.get("order"))
            vals = np.arange(n * 5, dtype=np.int64).reshape(n, 5) ** 2
            assert np.array_equal(schedules.execute_allreduce(syn, vals),
                                  ref_schedules.execute_allreduce(ref_syn, vals))


def _benches(g):
    """Every netsim benchmark on ``g``'s cluster, static and adaptive: name
    -> callable(module, cluster)."""
    out = {
        "pingpong_matrix": lambda m, cl: m.pingpong_matrix(cl, 2048.0).tolist(),
        "pingpong_fit": lambda m, cl: m.pingpong_fit(cl),
        "pingpong_mean": lambda m, cl: m.pingpong_mean_latency(cl, 512.0),
        "beff": lambda m, cl: m.effective_bandwidth(cl, n_sizes=3, n_random=2, seed=3),
        "ffte": lambda m, cl: m.ffte_1d(cl, 1 << 16),
        "graph500-bfs": lambda m, cl: m.graph500(cl, scale=10),
        "graph500-sssp": lambda m, cl: m.graph500(cl, scale=10, op="sssp"),
    }
    for op in ("bcast", "reduce", "scatter", "gather", "allreduce", "alltoall"):
        out[f"legacy-{op}"] = lambda m, cl, op=op: m.collective_bench(cl, op, 1024.0)
        out[f"synth-{op}"] = lambda m, cl, op=op: m.collective_bench(cl, op, 1024.0, "synth")
    for pattern in ("uniform", "random-perm", "shift", "hotspot"):
        out[f"traffic-{pattern}"] = lambda m, cl, p=pattern: m.traffic_time(
            cl, p, 4096.0, rounds=2, seed=1)
    if g.n in (16, 32):
        out["traffic-transpose"] = lambda m, cl: m.traffic_time(cl, "transpose")
    for kern in ("is", "ft", "cg", "mg", "lu"):
        for klass in ("S", "A"):
            out[f"npb-{kern}-{klass}"] = lambda m, cl, k=kern, c=klass: m.npb(cl, k, c)
    return out


@pytest.mark.parametrize("case", SMALL[:4], ids=SMALL_IDS[:4])
@pytest.mark.parametrize("routing_tier", ["static", "adaptive"])
def test_netsim_benchmarks_equal_reference(case, routing_tier):
    g, h = _pair(case)
    cl = dataclasses.replace(netsim.TAISHAN(g), routing=routing_tier)
    ref_cl = dataclasses.replace(ref_netsim.TAISHAN(h), routing=routing_tier)
    for name, bench in _benches(g).items():
        assert bench(netsim, cl) == bench(ref_netsim, ref_cl), name


def test_netsim_on_the_256_node_torus_equals_reference():
    g, h = graphs.torus([16, 16]), ref_graphs.torus([16, 16])
    cl, ref_cl = netsim.TAISHAN(g), ref_netsim.TAISHAN(h)
    cheap = {
        "pingpong_fit": lambda m, c: m.pingpong_fit(c),
        "pingpong_mean": lambda m, c: m.pingpong_mean_latency(c),
        "beff": lambda m, c: m.effective_bandwidth(c, n_sizes=2, n_random=1),
        "allreduce_recdbl": lambda m, c: m.collective_bench(c, "allreduce_recdbl", 8.0),
        "traffic-transpose": lambda m, c: m.traffic_time(c, "transpose"),
        "npb-cg-S": lambda m, c: m.npb(c, "cg", "S"),
    }
    for name, bench in cheap.items():
        assert bench(netsim, cl) == bench(ref_netsim, ref_cl), name
    adaptive = dataclasses.replace(cl, routing="adaptive")
    ref_adaptive = dataclasses.replace(ref_cl, routing="adaptive")
    assert netsim.traffic_time(adaptive, "hotspot", seed=2) == \
        ref_netsim.traffic_time(ref_adaptive, "hotspot", seed=2)


def test_routing_cache_is_a_bounded_lru_keyed_on_the_graph():
    netsim._ROUTING_CACHE.clear()
    hot = graphs.ring(10)
    rt = netsim.Cluster(graph=hot).routing_table()
    assert netsim.Cluster(graph=graphs.ring(10).with_name("other")).routing_table() is rt
    for i in range(netsim._ROUTING_CACHE_MAX):
        netsim.Cluster(graph=graphs.ring(12 + 2 * i)).routing_table()
        netsim.Cluster(graph=hot).routing_table()  # a hit moves it to the back
    assert len(netsim._ROUTING_CACHE) == netsim._ROUTING_CACHE_MAX
    assert netsim.Cluster(graph=hot).routing_table() is rt
    assert (12, graphs.ring(12).edges) not in netsim._ROUTING_CACHE
    assert netsim._ROUTING_CACHE_MAX == ref_netsim._ROUTING_CACHE_MAX


def test_netsim_refusals_equal_reference():
    edges = [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5)]
    for mod, gmod in ((netsim, graphs), (ref_netsim, ref_graphs)):
        cl = mod.TAISHAN(gmod.from_edges(6, edges, "two-triangles"))
        with pytest.raises(ValueError, match="disconnected"):
            mod.pingpong_matrix(cl)
        with pytest.raises(ValueError, match="routing="):
            mod.Cluster(graph=gmod.ring(8), routing="valiant")
        with pytest.raises(ValueError, match="schedule="):
            mod.collective_bench(mod.TAISHAN(gmod.ring(8)), "bcast", 8.0, schedule="mpi")
        with pytest.raises(ValueError, match="unknown NPB kernel"):
            mod.npb(mod.TAISHAN(gmod.ring(8)), "ep")
