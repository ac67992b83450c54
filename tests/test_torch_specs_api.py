"""The port's unified API layer (``repro_torch.core.specs``,
``repro_torch.core.topologies``, ``repro_torch.api``) against the JAX
package's, on the CPU.

Every strategy and the ``collective-time`` objective run through
``specs.search(spec, device="cpu")`` at small budgets and must return the
reference's result field for field; every family builds the reference's
graph; ``run_experiment`` over the paper's suites ``16``, ``32`` and
``dragonfly`` must give the reference's values, provenance, edges and
``table()`` text, serial and parallel.  The port's deliberate differences
are held too: ``device`` is a keyword (the CUDA device unless ``"cpu"``),
``engine`` takes only the circulant strategy's pricers, and ``parallel``
refuses a CUDA device before anything is built.
"""
import dataclasses
import json
import os
import subprocess
import sys
import warnings

import pytest
import torch

from repro import api as ref_api
from repro.core import graphs as ref_graphs
from repro.core import search as ref_search
from repro.core import specs as ref_specs
from repro.core import topologies as ref_topologies
from repro_torch import api
from repro_torch.core import certify, graphs, search, specs, topologies

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITES = ("16", "32", "dragonfly")
# tests/test_experiment_service.py's workloads
WORKLOADS = ("stats", ("alltoall", {"unit_bytes": 1 << 16}), "pingpong_mean")


def _fields(res):
    return dataclasses.astuple(res)


def _canon(mod, exp) -> str:
    """Everything an experiment produced but its timings, as JSON text."""
    return json.dumps(
        {"names": exp.names, "values": exp.values, "provenance": exp.provenance(),
         "edges": {n: list(g.edges) for n, g in exp.graphs.items()},
         "table": exp.table()},
        sort_keys=True, default=mod._json_default)


# (id, SearchSpec.make keyword arguments): every strategy, auto at each
# tier, the warm start, the graph_name param and the collective-time objective
SEARCHES = [
    ("pinned", dict(n=16, k=4, strategy="pinned")),
    ("auto-pinned", dict(n=32, k=3)),
    ("exhaustive", dict(n=10, k=3, strategy="exhaustive", budget=500)),
    ("sa", dict(n=16, k=3, strategy="sa", budget=300, seed=2)),
    ("auto-sa", dict(n=20, k=3, budget=200, replicas=2, graph_name="found")),
    ("sa-warm", dict(n=16, k=4, strategy="sa", budget=100, warm_start=True)),
    ("circulant-numpy", dict(n=64, k=4, strategy="circulant", budget=30, engine="numpy",
                             seed=1)),
    ("circulant-torch", dict(n=64, k=6, strategy="circulant", budget=20, engine="torch")),
    ("symmetric-sa", dict(n=64, k=4, strategy="symmetric-sa", budget=40, fold=4, seed=3)),
    ("symmetric-alias", dict(n=48, k=3, strategy="symmetric", budget=30, fold=2)),
    ("symmetric-warm", dict(n=256, k=4, strategy="symmetric-sa", budget=10,
                            warm_start=True)),
    ("large", dict(n=64, k=4, strategy="large", budget=20, polish_iters=30)),
    ("auto-large", dict(n=72, k=3, budget=10, polish_iters=20, fold=4)),
    ("collective-time", dict(n=12, k=3, objective="collective-time", budget=15,
                             op="bcast", unit_bytes=4096)),
    ("collective-time-allreduce", dict(n=10, k=3, objective="collective_time",
                                       budget=20)),
]


@pytest.mark.parametrize("kw", [c[1] for c in SEARCHES], ids=[c[0] for c in SEARCHES])
def test_search_equals_reference(kw):
    got = specs.search(specs.SearchSpec.make(**kw), device="cpu")
    # the port's batched pricer is the reference's "jax" one; every pricer
    # follows the same trajectory, so the reference runs its numpy pricer
    ref_kw = {**kw, "engine": "numpy"} if kw.get("engine") == "torch" else kw
    want = ref_specs.search(ref_specs.SearchSpec.make(**ref_kw))
    assert _fields(got) == _fields(want)


def test_device_tiers_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in (dict(strategy="symmetric-sa", budget=5), dict(strategy="large", budget=5),
               dict(strategy="circulant", engine="torch", budget=5)):
        with pytest.raises(RuntimeError, match="CUDA"):
            specs.search(specs.SearchSpec.make(64, 4, **kw))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.run_experiment({"r": "ring:16"}, ["stats"])
    with pytest.raises(RuntimeError, match="CUDA"):
        topologies.build_topology("suboptimal:64,4", n_iter=30)
    # the host tiers and the netsim workloads do not touch the device
    assert specs.search(specs.SearchSpec(16, 4)).mpl == 1.75
    exp = api.run_experiment({"r": "ring:16"}, ["pingpong_mean"])
    assert exp.values["r"]["pingpong_mean"] == \
        ref_api.run_experiment({"r": "ring:16"}, ["pingpong_mean"]).values["r"]["pingpong_mean"]


def test_suboptimal_build_equals_reference():
    spec = topologies.parse_topology("suboptimal:64,4", n_iter=60, seed=1)
    got = topologies.build_topology(spec, device="cpu")
    want = ref_topologies.build_topology(ref_topologies.parse_topology(
        "suboptimal:64,4", n_iter=60, seed=1))
    assert (got.n, got.edges, got.name) == (want.n, want.edges, want.name)


@pytest.mark.parametrize("text,kw", [
    ("ring:16", {}), ("complete:7", {}), ("wagner:32", {}), ("bidiakis:16", {}),
    ("chvatal", {}), ("chvatal:32", {}), ("chvatal32", {}), ("petersen", {}),
    ("circulant:32:1,7", {}), ("torus:4x8", {}), ("hypercube:5", {}),
    ("dragonfly:4,5,1", {}), ("dragonfly:3", {"h": 2}),
    ("random-regular:20,3", {"seed": 4}), ("random_hamiltonian_regular:16,4", {"seed": 2}),
    ("cluster-hub:4x8", {}), ("cluster-hub:3x5:ring:complete", {}),
    ("nested:ring/4:torus/2x4", {}), ("nested:petersen:ring/3", {"hub": 2}),
    ("optimal:16,4", {}), ("optimal:32,4", {"method": None}),
    ("optimal:16,3", {"budget": 200, "seed": 3}),
    ("optimal:64,6", {"strategy": "circulant", "budget": 20}),
])
def test_build_topology_equals_reference(text, kw):
    spec = topologies.parse_topology(text, **dict(kw))
    ref_spec = ref_topologies.parse_topology(text, **dict(kw))
    assert spec.to_json() == ref_spec.to_json()
    assert api._cache_key(spec) == ref_api._cache_key(ref_spec)
    got = api.build_topology(text, device="cpu", **dict(kw))
    want = ref_api.build_topology(text, **dict(kw))
    assert (got.n, got.edges, got.name) == (want.n, want.edges, want.name)


def test_registries_and_suites_equal_reference():
    assert topologies.topology_families() == ref_topologies.topology_families()
    assert specs.search_strategies() == ref_specs.search_strategies()
    assert specs.objective_names() == ref_specs.objective_names()
    assert api.workload_names() == ref_api.workload_names()
    assert api.CACHE_VERSION == ref_api.CACHE_VERSION
    for key in topologies.PAPER_SUITES:
        got, want = api.paper_suite(key), ref_api.paper_suite(key)
        assert list(got) == list(want)
        assert [s.to_json() for s in got.values()] == [s.to_json() for s in want.values()]
    with pytest.raises(ValueError, match="unknown paper suite"):
        api.paper_suite("64")
    with pytest.raises(ValueError, match="unknown topology family"):
        api.build_topology("mesh:4")


def test_spec_json_round_trips_and_reference_json_loads():
    specs_list = [
        specs.SearchSpec.make(2048, 6, strategy="large", budget=100, fold=8, seed=3,
                              start_offsets=[1, 5, 9]),
        specs.SearchSpec(32, 4, objective="collective-time", params={"op": "bcast"}),
        specs.SearchSpec(8192, 8, strategy="circulant", engine="torch"),
    ]
    for spec in specs_list:
        assert specs.SearchSpec.from_json(spec.to_json()) == spec
        assert spec.to_json() == ref_specs.SearchSpec.from_json(spec.to_json()).to_json()
    # a reference spec with a reference-only engine loads, and refuses to run
    ref_json = ref_specs.SearchSpec(64, 4, strategy="symmetric-sa", engine="bitset").to_json()
    loaded = specs.SearchSpec.from_json(ref_json)
    assert loaded.engine == "bitset" and loaded.to_json() == ref_json
    with pytest.raises(ValueError, match="no counterpart"):
        specs.search(loaded, device="cpu")
    topo = topologies.TopologySpec.make("nested", outer="ring:4", inner="torus:2x4", seed=2)
    assert topologies.TopologySpec.from_json(topo.to_json()) == topo
    assert topo.to_json() == ref_topologies.TopologySpec.from_json(topo.to_json()).to_json()


@pytest.mark.parametrize("engine,strategy,ok", [
    (None, "large", True), ("auto", "symmetric-sa", True), ("auto", "sa", True),
    ("numpy", "circulant", True), ("torch", "circulant", True),
    ("jax", "circulant", False), ("numpy", "sa", False), ("numpy", "large", False),
    ("c", "symmetric-sa", False), ("bitset", "large", False), ("pallas", "auto", False),
])
def test_engine_takes_the_ports_vocabulary_only(engine, strategy, ok):
    spec = specs.SearchSpec(128 if strategy == "auto" else 64, 4, strategy=strategy,
                            engine=engine)
    if ok:
        assert specs.resolve_strategy(spec).engine == engine
    else:
        with pytest.raises(ValueError, match="no counterpart"):
            specs.resolve_strategy(spec)
    assert api.engine_names() == {"rows": (), "circulant": ("numpy", "torch")}
    assert specs.strategy_engine_domain("circulant") == ("numpy", "torch")
    assert specs.strategy_engine_domain("large") == ()


def test_run_experiment_engine_override_reaches_the_circulant_tier_only():
    suite = {"c": topologies.TopologySpec.make("optimal", n=64, k=4, strategy="circulant",
                                               budget=20),
             "s": topologies.TopologySpec.make("optimal", n=16, k=4)}
    got = api.run_experiment(suite, ["pingpong_mean"], engine="torch", device="cpu")
    # the reference names its batched pricer "jax"; every pricer gives the same graphs
    ref_suite = {
        "c": ref_topologies.TopologySpec.make("optimal", n=64, k=4, strategy="circulant",
                                              budget=20),
        "s": ref_topologies.TopologySpec.make("optimal", n=16, k=4)}
    want = ref_api.run_experiment(ref_suite, ["pingpong_mean"], engine="numpy")
    assert got.provenance()["c"]["params"]["engine"] == "torch"
    assert "engine" not in got.provenance()["s"]["params"]
    assert {n: g.edges for n, g in got.graphs.items()} == \
        {n: g.edges for n, g in want.graphs.items()}
    for bad in ("jax", "bitset"):
        with pytest.raises(ValueError, match="no counterpart"):
            api.run_experiment(suite, ["pingpong_mean"], engine=bad, device="cpu")


@pytest.mark.parametrize("suite", SUITES)
def test_run_experiment_equals_reference_serial_and_parallel(suite, tmp_path):
    cache = str(tmp_path / "cache")
    want = ref_api.run_experiment(ref_api.paper_suite(suite), WORKLOADS, parallel=False)
    serial = api.run_experiment(api.paper_suite(suite), WORKLOADS, cache_dir=cache,
                                parallel=False, device="cpu")
    assert _canon(api, serial) == _canon(ref_api, want)
    # the forked pool on the CPU, from the cache the serial run filled
    par = api.run_experiment(api.paper_suite(suite), WORKLOADS, cache_dir=cache,
                             parallel=True, jobs=2, device="cpu")
    assert _canon(api, par) == _canon(api, serial)
    for exp in (serial, par):
        for n in exp.names:
            assert set(exp.seconds[n]) == set(exp.values[n])
    # the table's stats cell is the reference's text too
    assert serial.table().splitlines() == want.table().splitlines()


def test_reference_cache_file_serves_the_port(tmp_path):
    cache = str(tmp_path / "cache")
    spec = ref_topologies.TopologySpec.make("optimal", n=16, k=3, budget=200)
    want = ref_api.build_topology(spec, cache_dir=cache)
    [fn] = os.listdir(cache)
    port_spec = topologies.TopologySpec.make("optimal", n=16, k=3, budget=200)
    assert api._cache_key(port_spec) + ".json" == fn
    with open(os.path.join(cache, fn)) as f:
        recorded = json.load(f)
    recorded["name"] = "served from the cache"
    with open(os.path.join(cache, fn), "w") as f:
        json.dump(recorded, f)
    got = api.build_topology(port_spec, cache_dir=cache, device="cpu")
    assert got.name == "served from the cache" and got.edges == want.edges


@pytest.mark.parametrize("device", [None, "cuda", torch.device("cuda", 0)])
def test_parallel_refuses_a_cuda_device_before_any_build(device, monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("built before refusing")

    monkeypatch.setattr(api, "build_topology", no_build)
    with pytest.raises(ValueError, match="CUDA device"):
        api.run_experiment({"r": "ring:16", "t": "torus:4x4"}, ["stats"],
                           parallel=True, device=device)
    monkeypatch.setenv("REPRO_PARALLEL", "1")
    with pytest.raises(ValueError, match="CUDA device"):
        api.run_experiment({"r": "ring:16"}, ["pingpong_mean"], device=device)


def test_parallel_env_and_fallbacks_on_the_cpu(monkeypatch):
    suite = {"r": "ring:16", "t": "torus:4x4"}
    monkeypatch.setenv("REPRO_PARALLEL", "1")
    par = api.run_experiment(suite, ["stats", "pingpong_mean"], device="cpu")
    monkeypatch.setenv("REPRO_PARALLEL", "0")
    ser = api.run_experiment(suite, ["stats", "pingpong_mean"], device="cpu")
    assert _canon(api, par) == _canon(api, ser)
    captured = []

    def factory(g):  # a closure: unpicklable, so the pool falls back to serial
        captured.append(g.name)
        from repro_torch.core import netsim
        return netsim.TAISHAN(g)

    exp = api.run_experiment(suite, ["pingpong_mean"], cluster_factory=factory,
                             parallel=True, device="cpu")
    assert captured and set(exp.values) == {"r", "t"}


def test_deprecated_delegates_equal_the_spec_path():
    with pytest.warns(DeprecationWarning, match="find_optimal is deprecated"):
        got = search.find_optimal(16, 3, seed=1, budget=200, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref_search.find_optimal(16, 3, seed=1, budget=200)
        ref_built = ref_graphs.build("torus:4x8")
    assert (got.edges, got.name) == (want.edges, want.name)
    assert got.edges == specs.search(specs.SearchSpec(16, 3, seed=1, budget=200),
                                     device="cpu").graph.edges
    with pytest.warns(DeprecationWarning, match="graphs.build is deprecated"):
        built = graphs.build("torus:4x8")
    assert (built.edges, built.name) == (ref_built.edges, ref_built.name)
    with pytest.warns(DeprecationWarning):
        sub = graphs.build("optimal:64,4", device="cpu", strategy="circulant", budget=10)
    assert sub.edges == topologies.build_topology(
        "optimal:64,4", "cpu", strategy="circulant", budget=10).edges


def test_certify_warm_start_through_the_registry():
    entry = certify.get_entry(16, 4)
    spec_entry = {"name": "spec", "n": 32, "spec": {"family": "chvatal32", "params": {}}}
    assert certify.build_entry_graph(spec_entry).edges == graphs.chvatal32().edges
    assert certify.build_entry_graph(entry).edges == \
        specs.search(specs.SearchSpec(16, 4)).graph.edges


def test_cli_equals_reference(tmp_path):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "topologies": {"r": "ring:16", "o": {"family": "optimal", "params": {"n": 16, "k": 4}},
                       "t": "torus:4x4"},
        "workloads": ["stats", ["alltoall", {"unit_bytes": 4096}],
                     {"workload": "traffic", "key": "hot", "pattern": "hotspot"}],
        "routing": "adaptive"}))
    out, ref_out = tmp_path / "port.json", tmp_path / "ref.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.api", str(spec), "-o", str(out), "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert proc.returncode == 0, proc.stderr
    assert ref_api.main([str(spec), "-o", str(ref_out)]) == 0
    got, want = json.loads(out.read_text()), json.loads(ref_out.read_text())
    assert set(got.pop("seconds")) == set(want.pop("seconds"))
    assert got == want
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"suite": "16", "engine": "bitset"}))
    with pytest.raises(SystemExit, match="no counterpart"):
        api.main([str(bad), "--device", "cpu"])
