"""Rules of the PyTorch port as a package: it imports neither JAX nor the
JAX package, and it runs on the CUDA device unless the caller asks for the
CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import device as port_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    bench = os.path.join(REPO, "benchmarks")
    out += [os.path.join(bench, f) for f in os.listdir(bench)
            if f.startswith("torch_") and f.endswith(".py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) >= 12
    names = {os.path.relpath(p, REPO) for p in files}
    assert {"src/repro_torch/core/layout.py", "src/repro_torch/runtime/failures.py",
            "src/repro_torch/comm/torchcoll.py", "benchmarks/torch_common.py",
            "benchmarks/torch_run.py"} <= names
    bad = {(os.path.relpath(p, REPO), mod) for p in files
           for mod in _imported_roots(p) if mod in ("jax", "jaxlib", "repro")}
    assert not bad, f"forbidden imports: {sorted(bad)}"


def test_importing_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.core.search, repro_torch.api, repro_torch.comm.schedules, "
            "repro_torch.core.netsim, repro_torch.core.topologies, "
            "repro_torch.core.hamiltonian, repro_torch.core.traffic, "
            "repro_torch.kernels._build, "
            "repro_torch.kernels.ops, repro_torch.configs, repro_torch.models, "
            "repro_torch.serve, repro_torch.launch.serve, repro_torch.core.layout, "
            "repro_torch.runtime, repro_torch.comm.torchcoll, benchmarks.torch_run; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ,
                               "PYTHONPATH": os.pathsep.join([os.path.join(REPO, "src"), REPO])})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_device.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        port_device.resolve_device("meta")
    from repro_torch.core import search

    with pytest.raises(RuntimeError, match="CUDA"):
        search.large_search(64, 4, replicas=2, polish_iters=2)


def test_serving_entry_points_need_cuda_by_default(monkeypatch):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(get_config("zamba2-2.7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_config("zamba2-2.7b"))
    # the launcher (ServingEngine behind it) runs on the card unless asked
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--requests", "1", "--slots", "1"])
    assert build_model(cfg, device="cpu").device == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_cuda_or_outside_a_checkout(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    proc = subprocess.run([sys.executable, str(lone)], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path, env=env)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
