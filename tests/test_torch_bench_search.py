"""The port's search benchmark (``benchmarks/torch_bench_search.py``)
against the reference's (``benchmarks/bench_search.py``) on the CPU.

The ``sa_``, ``warmstart_``, ``circulant_`` and ``fig4_schedule`` rows run
at ``--smoke`` size with ``--device cpu``; every field that is not a time
is held to the reference: each row's spec JSON to the reference's spec,
the search's results to the reference's ``api.search`` of that spec, the
seed baseline to the reference's ``_seed_sa_search`` and the schedule row
to the reference's ``schedules`` and ``netsim``.  The full and smoke row
lists are held to the rows the reference benchmark emits, collected by
running its ``run`` with every search and timing call stubbed out.
"""
import json
import types

import numpy as np
import pytest

from benchmarks import bench_search as ref_bench
from benchmarks import torch_bench_search as bench
from repro import api as ref_api

TIMES = {"engine_s", "seed_s", "speedup", "warm_s", "cold_s", "wall_s"}


def _reference_rows(smoke: bool, monkeypatch) -> list[str]:
    """The row names the reference's ``run`` emits, every search stubbed."""
    from repro.comm import schedules
    from repro.core import netsim

    fake = types.SimpleNamespace(mpl=2.0, diameter=3.0, evals_delta=0, evals_full=0,
                                 offsets=(1,), device_dispatches=0, graph=None)
    monkeypatch.setattr(ref_bench.api, "search", lambda spec: fake)
    monkeypatch.setattr(ref_bench.api, "build_topology", lambda spec: None)
    monkeypatch.setattr(ref_bench, "_seed_sa_search", lambda *a, **kw: (2.0, 3.0))
    monkeypatch.setattr(schedules, "synthesize", lambda *a: types.SimpleNamespace(
        algorithm="x", time=1.0))
    monkeypatch.setattr(netsim, "TAISHAN", lambda g: None)
    monkeypatch.setattr(netsim, "collective_bench", lambda *a: 1.0)
    return [r["name"] for r in ref_bench.run(smoke=smoke).results]


@pytest.mark.parametrize("smoke", [False, True])
def test_rows_are_the_reference_rows(smoke, monkeypatch):
    assert bench.row_names(smoke) == _reference_rows(smoke, monkeypatch)


@pytest.fixture(scope="module")
def smoke_rows():
    rows = bench.run(smoke=True, device="cpu",
                     only=("sa_", "warmstart_", "circulant_", "fig4_schedule"))
    return {r["name"]: r for r in rows.results}, rows


def _ref_search(row):
    spec = ref_api.SearchSpec.from_json(json.dumps(row["spec"]))
    assert json.loads(spec.to_json()) == row["spec"]
    return ref_api.search(spec)


def test_smoke_rows_run_in_order(smoke_rows):
    results, rows = smoke_rows
    want = [n for n in bench.row_names(smoke=True)
            if n.startswith(("sa_", "warmstart_", "circulant_", "fig4_schedule"))]
    assert list(results) == want == ["sa_n32_k4", "warmstart_n32_k4", "circulant_n256_k6",
                                     "fig4_schedule"]
    assert [name for name, _, _ in rows.rows] == [f"bench_search/{n}" for n in want]
    machine = rows.meta["machine"]
    assert machine["c_kernel"] is True and machine["nvidia_smi"] is None
    assert rows.meta["smoke"] is True
    for r in results.values():
        assert all(r[t] >= 0 for t in TIMES & set(r))


def test_sa_row_matches_reference(smoke_rows):
    row = smoke_rows[0]["sa_n32_k4"]
    spec = ref_api.SearchSpec.make(32, 4, seed=0, strategy="sa", budget=1000, replicas=1,
                                   target_mpl=None)
    assert row["spec"] == json.loads(spec.to_json())
    res = _ref_search(row)
    seed_mpl, _ = ref_bench._seed_sa_search(32, 4, seed=0, n_iter=1000)
    lb = res.mpl_lb
    assert (row["engine_mpl"], row["seed_mpl"], row["mpl_lb"], row["evals_delta"],
            row["evals_full"], row["iters"], row["n"], row["k"]) == \
        (res.mpl, seed_mpl, lb, res.evals_delta, res.evals_full, 1000, 32, 4)
    assert row["gap_pct"] == round((res.mpl / lb - 1) * 100, 2)


def test_warmstart_row_matches_reference(smoke_rows):
    row = smoke_rows[0]["warmstart_n32_k4"]
    warm = _ref_search(row)
    cold_spec = ref_api.SearchSpec.make(32, 4, seed=1, strategy="sa", budget=300,
                                        replicas=1, target_mpl=None)
    warm_spec = cold_spec.with_overrides(params={**cold_spec.kwargs, "warm_start": True})
    assert row["spec"] == json.loads(warm_spec.to_json())
    cold = ref_api.search(cold_spec)
    assert (row["warm_mpl"], row["cold_mpl"], row["mpl_lb"], row["iters"]) == \
        (warm.mpl, cold.mpl, warm.mpl_lb, 300)
    assert row["warm_mpl"] <= row["cold_mpl"]
    assert row["gap_pct"] == round((warm.mpl / warm.mpl_lb - 1) * 100, 2)


def test_circulant_row_matches_reference(smoke_rows):
    row = smoke_rows[0]["circulant_n256_k6"]
    spec = ref_api.SearchSpec.make(256, 6, seed=0, strategy="circulant", budget=200)
    assert row["spec"] == json.loads(spec.to_json())
    res = _ref_search(row)
    assert (row["mpl"], row["mpl_lb"], row["diameter"], row["offsets"], row["iters"]) == \
        (res.mpl, res.mpl_lb, res.diameter, list(res.offsets), 200)
    assert row["gap_pct"] == round((res.mpl / res.mpl_lb - 1) * 100, 2)


def test_fig4_schedule_row_matches_reference(smoke_rows):
    from repro.comm import schedules
    from repro.core import netsim

    row = smoke_rows[0]["fig4_schedule"]
    spec = ref_api.SearchSpec.make(16, 4, objective="collective-time", seed=0, budget=150,
                                   op="allreduce", unit_bytes=1 << 18)
    assert row["spec"] == json.loads(spec.to_json())
    res = _ref_search(row)
    synth = schedules.synthesize(res.graph, "allreduce", 1 << 18)
    base = {name: netsim.collective_bench(netsim.TAISHAN(ref_api.build_topology(s)),
                                          "allreduce", float(1 << 18))
            for name, s in (("ring", "ring:16"), ("torus", "torus:4x4"))}
    assert (row["mpl"], row["algorithm"], row["synth_s"], row["ring_s"], row["torus_s"]) == \
        (res.mpl, synth.algorithm, synth.time, base["ring"], base["torus"])
    assert row["ratio_vs_ring"] == round(base["ring"] / synth.time, 4)
    assert row["ratio_vs_torus"] == round(base["torus"] / synth.time, 4)
    assert row["ratio_vs_ring"] > 1


def test_cli_smoke_rows_print_and_need_the_device(capsys, monkeypatch, tmp_path):
    out = tmp_path / "rows.json"
    monkeypatch.setattr(bench.common, "OUT_DIR", str(tmp_path))
    bench.main(["--smoke", "--device", "cpu", "--only", "warmstart_", "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("bench_search/warmstart_n32_k4,")
    assert json.loads(lines[1])["name"] == "warmstart_n32_k4"
    saved = json.loads(out.read_text())
    assert [r["name"] for r in saved["results"]] == ["warmstart_n32_k4"]
    assert saved["machine"]["c_kernel"] is True
    assert (tmp_path / "BENCH_search.json").is_file()
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(smoke=True, only=("warmstart_",))
    np.testing.assert_equal(bench._mpl_full(np.ones((3, 3), bool) ^ np.eye(3, dtype=bool)),
                            (1.0, 1.0))
