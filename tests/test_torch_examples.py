"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/quickstart.py``, ``topology_sweep.py``, ``serve_demo.py``,
``train_lm.py``, ``elastic_failover.py``) on the CPU.

Each port example runs with ``--device cpu`` in a subprocess.  The
quickstart and the topology sweep print the reference example's output line
for line (the reference's expected lines are produced by running the
reference example as ``__main__`` in this process).  The serving demo draws its weights
from a ``torch.Generator``, so its tokens are not the reference's; its lines
keep the reference's prompts and format, and its serving loop, given the
reference's weights through ``repro_torch.convert`` in float32 at
temperature 0, gives the reference's greedy tokens request by request.
"""
import contextlib
import dataclasses
import importlib
import io
import os
import re
import runpy
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
sys.path.insert(0, EXAMPLES)


def _run(script: str, *args: str, **env_extra: str) -> list[str]:
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([os.path.join(REPO, "src"), REPO]), **env_extra}
    proc = subprocess.run([sys.executable, os.path.join(EXAMPLES, script), *args],
                          capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def _run_reference(script: str, *args: str) -> list[str]:
    out = io.StringIO()
    argv = sys.argv
    sys.argv = [script, *args]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(EXAMPLES, script), run_name="__main__")
    except SystemExit as done:  # topology_sweep.py ends in raise SystemExit(main())
        assert done.code == 0
    finally:
        sys.argv = argv
    return out.getvalue().splitlines()


@pytest.mark.parametrize("script,args", [
    ("quickstart.py", ()),
    ("topology_sweep.py", ("--nodes", "16", "--budget", "200")),
    ("topology_sweep.py", ()),
])
def test_example_prints_the_reference_lines(script, args):
    got = _run("torch_" + script, *args, "--device", "cpu")
    want = _run_reference(script, *args)
    assert got == want
    assert len(got) >= 7


def test_serve_demo_keeps_the_reference_prompts_and_format():
    lines = _run("torch_serve_demo.py", "--device", "cpu", "--temperature", "0")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 6).astype(np.int32).tolist() for _ in range(8)]
    reqs = [ln for ln in lines if ln.startswith("req ")]
    assert [int(ln.split(":")[0][4:]) for ln in reqs] == [0, 1, 4, 5]
    for ln in reqs:
        m = re.fullmatch(r"req (\d+): prompt (\[[\d, ]+\]) -> (\[[\d, ]+\])", ln)
        assert m and eval(m.group(2)) == prompts[int(m.group(1))]
        assert len(eval(m.group(3))) == 16
    assert re.fullmatch(r"8 requests, 128 tokens \| TTFT \d+ ms \| [\d.]+ tok/s", lines[-1])


def test_serve_demo_loop_gives_the_reference_tokens():
    """The example's serving loop on the reference's float32 weights at
    temperature 0 against the reference example's loop, request by request."""
    from repro.configs import get_config as jget_config
    from repro.configs import reduced_config as jreduced_config
    from repro.models import build_model as jbuild_model
    from repro.serve import DecodeParams as JDecodeParams
    from repro.serve import Request as JRequest
    from repro.serve import ServingEngine as JServingEngine
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import params_from_reference
    from repro_torch.models import build_model

    import torch_serve_demo

    arch, slots, requests, max_new = "qwen3-32b", 4, 8, 16
    jcfg = dataclasses.replace(jreduced_config(jget_config(arch)), dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    params.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, jp)))

    # the reference example's loop (examples/serve_demo.py), at temperature 0
    rng = np.random.default_rng(0)
    jeng = JServingEngine(jm, jp, max_seq=64, slots=slots,
                          decode=JDecodeParams(temperature=0.0, max_new_tokens=max_new))
    jdone, rid, remaining = [], 0, requests
    while remaining:
        wave = min(slots, remaining)
        for _ in range(wave):
            jeng.submit(JRequest(rid=rid, prompt=rng.integers(0, jcfg.vocab, 6).astype(np.int32),
                                 max_new_tokens=max_new))
            rid += 1
        jeng.lanes = [None] * slots
        jeng.cache = None
        jdone += jeng.run()
        remaining -= wave

    printed = []
    done, st = torch_serve_demo.serve(m, params, requests, slots, max_new, 0.0,
                                      out=printed.append)
    assert {r.rid: r.out_tokens for r in done} == {r.rid: r.out_tokens for r in jdone}
    assert [r.prompt.tolist() for r in done] == [r.prompt.tolist() for r in jdone]
    assert len(printed) == 4 and st["requests"] == requests
    assert st["tokens"] == requests * max_new


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_topology_sweep",
                                  "torch_serve_demo", "torch_train_lm",
                                  "torch_elastic_failover"])
def test_examples_need_the_device_by_default(name, monkeypatch, capsys):
    """Without ``--device cpu`` the examples raise on a machine without CUDA,
    before printing anything."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(name)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
    assert capsys.readouterr().out == ""


def test_train_lm_learns_on_a_mesh():
    """``examples/torch_train_lm.py`` at a few steps on a world-size-1 mesh
    of one gloo rank: the reference example's fresh-start and LEARNING
    lines."""
    # one intra-op thread: as fast alone, and it does not fight the other
    # test workers for the host's cores
    lines = _run("torch_train_lm.py", "--device", "cpu", "--steps", "40", "--mesh",
                 OMP_NUM_THREADS="1")
    assert lines[0] == "fresh start"
    m = re.fullmatch(r"loss ([\d.]+) -> ([\d.]+) over 40 steps \(LEARNING\)", lines[-1])
    assert m and float(m.group(2)) < float(m.group(1)) - 0.1


def test_elastic_failover_plans_as_the_reference():
    """``examples/torch_elastic_failover.py``: the failure detector's and the
    remesh plan's lines equal those of the reference example's code
    (``repro.runtime`` with the example's arguments); the checkpoint is
    restored onto a mesh and training resumes."""
    from repro.core import graphs as jgraphs
    from repro.runtime import FailureDetector as JFailureDetector
    from repro.runtime import plan_elastic_remesh as jplan_elastic_remesh

    got = _run("torch_elastic_failover.py", "--device", "cpu", OMP_NUM_THREADS="1")
    # the reference example's detector and plan, with its arguments
    fd = JFailureDetector(n_nodes=32, timeout_s=10)
    for i in range(32):
        fd.heartbeat(i, t=0.0 if i in (3, 12, 17) else 100.0)
    dead = fd.dead(now=105.0)
    plan = jplan_elastic_remesh(jgraphs.torus([4, 8]), dead, axis_bytes=(1e6, 8e6),
                                layout_iters=3000)
    want = [f"failure detector reports dead: {dead}",
            f"remesh plan: shape {plan.mesh_shape}, layout improvement "
            f"{plan.layout_improvement:.1%}, survivors used: {len(plan.device_order)}",
            "restored at step 10, data step 10; resuming", "elastic failover complete"]
    keep = ("failure detector", "remesh plan", "restored at", "elastic failover")
    assert [ln for ln in got if ln.startswith(keep)] == want
    assert any(ln.startswith("step    10 loss") for ln in got)
