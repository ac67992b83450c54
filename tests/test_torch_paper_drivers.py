"""The port's table and figure modules (``benchmarks/torch_*.py``)
against the reference's (``benchmarks/*.py``).

Over suites 16 and 32 (Table 1, Figs 2–8) and the dragonfly suites
(Tables 2/3 and 5/6) both modules run on the CPU (the port with
``device="cpu"``), each with its graph cache in a temporary directory, and
their rows must be equal: the same names, the same derived strings, and the
same values where a row's number is a value, not wall seconds (Table 1's
and Fig 2's numbers and Tables 2/3 and 5/6's ``props/`` rows are host
seconds and are not compared).  No tolerance: the same float operations in
the same order.  The modules over the 256-node suite (Table 4, Fig 10),
whose searched builds take minutes on a CPU, are held here to the
reference modules' suites, workloads and row names, and each large module
is run beside its reference over one seeded synthetic experiment result,
where rows, values and derived strings must be equal: that holds each
module's own arithmetic and formatting (which ratio, which way up).  The
experiment values behind Table 4 and Fig 10 are held to the JAX package's
on the card by ``chip_smoke.py`` (phase 21), and Tables 2/3 and 5/6's rows
and fig_routing's values by phase 24."""
import importlib
import json
import re

import numpy as np
import pytest
import torch

import benchmarks.common as ref_common
import benchmarks.torch_common as port_common
from benchmarks import torch_run
from repro.api import _json_default as ref_json
from repro_torch.api import _json_default as port_json

SMALL = ("table1", "fig2", "fig3", "fig4", "fig5", "fig6", "fig7", "fig8")
DRAGONFLY = ("table2_3", "table5_6")  # a few seconds each on a CPU
LARGE = ("table2_3", "table4", "table5_6", "fig10")
# the reference module of each port module
REFERENCE = {
    "table1": "table1_graph_properties", "fig2": "fig2_pingpong",
    "fig3": "fig3_pingpong_ratios", "fig4": "fig4_collectives", "fig5": "fig5_beff",
    "fig6": "fig6_ffte", "fig7": "fig7_graph500", "fig8": "fig8_npb",
    "table2_3": "table2_3_dragonfly", "table4": "table4_large_scale",
    "table5_6": "table5_6_large_dragonfly", "fig10": "fig10_large_sim",
    "fig_routing": "fig_routing",
}
WALL_SECONDS = {"table1", "fig2"}  # row numbers that are host seconds


def _value_rows(key, rows):
    """(name, number) of each row whose number is a value, not host seconds."""
    if key in WALL_SECONDS:
        return []
    return [(n, u) for n, u, _ in rows if "/props/" not in n]


def _ref(key):
    return importlib.import_module(f"benchmarks.{REFERENCE[key]}")


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    return tmp_path_factory.mktemp("ref_cache"), tmp_path_factory.mktemp("port_cache")


@pytest.mark.parametrize("key", SMALL + DRAGONFLY)
def test_module_rows_equal_the_reference(key, caches, monkeypatch):
    ref_dir, port_dir = caches
    monkeypatch.setattr(ref_common, "CACHE_DIR", str(ref_dir))
    monkeypatch.setattr(port_common, "CACHE_DIR", str(port_dir))
    want = _ref(key).run()
    got = torch_run.MODULES[key].run(device="cpu")
    assert (got.bench, got.artifact) == (want.bench, want.artifact)
    assert [(n, d) for n, _, d in got.rows] == [(n, d) for n, _, d in want.rows]
    assert _value_rows(key, got.rows) == _value_rows(key, want.rows)
    assert json.dumps(got.results, default=port_json, sort_keys=True) == \
        json.dumps(want.results, default=ref_json, sort_keys=True)
    if key == "table1":
        assert all("match=Y" in d for _, _, d in got.rows)


@pytest.mark.parametrize("key", ["table2_3", "table4", "table5_6", "fig10", "fig_routing"])
def test_large_modules_keep_the_reference_constants(key):
    port, ref = torch_run.MODULES[key], _ref(key)
    for name in ("PAPER", "PAPER_T2", "WORKLOADS", "TOPOLOGIES", "PATTERNS", "NBYTES", "SEED"):
        assert getattr(port, name, None) == getattr(ref, name, None), name
    src_port = open(port.__file__).read()
    src_ref = open(ref.__file__).read()
    # the same suites and the same row names, text for text
    pat = r'paper_suite\("[^"]+"\)|rows\.add\(f?"[^"]*"'
    assert re.findall(pat, src_port) == re.findall(pat, src_ref)


def _synthetic_experiment(api, metrics, suite, workloads, seed):
    """One package's ``ExperimentResult`` over ``suite``'s names with seeded
    values: a ``GraphStats`` for ``stats``, a positive float for every
    other workload, a positive float of seconds for every cell."""
    rng = np.random.default_rng(seed)
    names = list(suite)
    values, seconds = {}, {}
    for name in names:
        values[name], seconds[name] = {}, {}
        for w in workloads:
            key = w[0] if isinstance(w, tuple) else w
            if key == "stats":
                diameter, d_lb = (int(v) for v in rng.integers(2, 130, 2))
                values[name][key] = metrics.GraphStats(
                    name, 256, int(rng.integers(2, 12)), float(diameter),
                    float(rng.uniform(1.5, 65.0)), int(rng.integers(2, 320)),
                    float(rng.integers(3, 9)), d_lb, float(rng.uniform(1.5, 65.0)))
            else:
                values[name][key] = float(rng.uniform(1e-4, 10.0))
            seconds[name][key] = float(rng.uniform(0.0, 30.0))
    return api.ExperimentResult(names=names, specs={n: None for n in names}, graphs={},
                                values=values, seconds=seconds)


@pytest.mark.parametrize("key", LARGE)
def test_large_modules_format_the_same_experiment(key, monkeypatch):
    """Each large module and its reference, handed the same seeded
    experiment result in place of ``run_experiment``'s, give the same rows:
    names, numbers and derived strings, exactly."""
    import repro.api as ref_api
    import repro.core.metrics as ref_metrics
    import repro_torch.api as port_api
    import repro_torch.core.metrics as port_metrics

    port, ref = torch_run.MODULES[key], _ref(key)
    assert (port.api, ref.api) == (port_api, ref_api)
    calls = []

    def fake(api, metrics):
        def run_experiment(suite, workloads=("stats",), **kw):
            calls.append((list(suite), list(workloads)))
            return _synthetic_experiment(api, metrics, suite, list(workloads), seed=22)
        return run_experiment

    monkeypatch.setattr(ref_api, "run_experiment", fake(ref_api, ref_metrics))
    monkeypatch.setattr(port_api, "run_experiment", fake(port_api, port_metrics))
    want, got = ref.run(), port.run(device="cpu")
    assert calls[0] == calls[1] and len(calls) == 2
    assert got.rows == want.rows and len(got.rows) >= 10
    assert len({d for _, _, d in got.rows}) > 1


def test_torch_run_covers_the_reference_modules():
    import benchmarks.run as ref_run

    assert set(torch_run.MODULES) == set(ref_run.MODULES) - {"roofline", "topology_term",
                                                             "bench_search"}
    assert torch_run.SMOKE_KEYS == [k for k in ref_run.SMOKE_KEYS if k != "bench_search"]
    for key, mod in torch_run.MODULES.items():
        assert mod.__name__ == f"benchmarks.torch_{REFERENCE[key]}"


def test_torch_run_smoke_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``--smoke --device cpu`` runs fig4 and fig_routing and writes their
    artifacts under the port's own directory."""
    monkeypatch.setattr(port_common, "CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(port_common, "OUT_DIR", str(tmp_path / "out"))
    out = torch_run.main(["--smoke", "--device", "cpu"])
    assert list(out) == ["fig4", "fig_routing"]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == \
        ["BENCH_fig4.json", "BENCH_routing.json"]
    routing = json.loads((tmp_path / "out" / "BENCH_routing.json").read_text())
    row = next(r for r in routing["results"] if r["key"] == "torus_alltoall")
    assert row["adaptive_vs_static"] > 1
    assert "fig4/alltoall-1MB/(16,4)-Optimal" in capsys.readouterr().out


def test_torch_run_refuses_without_cuda_and_parallel_on_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_run.main(["--only", "fig_routing"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit):
        torch_run.main(["--only", "fig_routing", "--parallel"])
    monkeypatch.setenv("REPRO_PARALLEL", "1")
    with pytest.raises(SystemExit):
        torch_run.main(["--only", "fig_routing", "--device", "cuda"])
    with pytest.raises(SystemExit):
        torch_run.main(["--only", "nope", "--device", "cpu"])


def test_port_artifacts_never_touch_the_reference_paths():
    assert port_common.CACHE_DIR != ref_common.CACHE_DIR
    assert port_common.CACHE_DIR.endswith("torch_benchcache")
    assert port_common.OUT_DIR.endswith("torch_benchmarks")
