"""The port's ``Trainer`` against the JAX package's ``Trainer`` with the
same start weights: reduced qwen3-32b with 1 and 2 microbatches (fp32
accumulation then division, as the reference's scan) and reduced
grok-1-314b (Adafactor, the router's aux loss), 4 steps, per-step loss,
grad norm and lr within a relative 1e-4; the final weights within 1e-4.
Then the port alone: a restart from a checkpoint equals an uninterrupted
run bit for bit, the failure hook, the straggler count (as
``tests/test_train.py`` checks the reference) and the launcher
``python -m repro_torch.launch.train --device cpu``."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_model as jbuild_model
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import Trainer as JTrainer
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer


def _quiet(*_):
    pass


def _port_trainer(tmp=None, arch="qwen3-32b", every=100, **kw):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    return Trainer(model=build_model(cfg, device="cpu"),
                   opt=make_optimizer(cfg.optimizer, lr=3e-3, total_steps=200, warmup=2),
                   data=SyntheticLM(cfg, DataConfig(seq_len=32, global_batch=8, seed=0)),
                   ckpt_dir=tmp, ckpt_every=every)


@pytest.mark.parametrize("arch,microbatches", [("qwen3-32b", 1), ("qwen3-32b", 2),
                                               ("grok-1-314b", 1)])
def test_trainer_follows_the_reference(arch, microbatches):
    kw = dict(dtype="float32", microbatches=microbatches)
    jcfg = dataclasses.replace(jreduced_config(jget_config(arch)), **kw)
    jt = JTrainer(model=jbuild_model(jcfg),
                  opt=jmake_optimizer(jcfg.optimizer, lr=3e-3, total_steps=200, warmup=2),
                  data=JSyntheticLM(jcfg, JDataConfig(seq_len=32, global_batch=8, seed=0)))
    jt.init(0)
    pt = _port_trainer(arch=arch, **kw)
    pt.init(0)
    cfg = pt.model.cfg
    pt.state["params"].load_state_dict(
        params_from_reference(cfg, jax.tree.map(np.asarray, jt.state["params"])))
    want = jt.train(4, log_every=0)
    got = pt.train(4, log_every=0)
    assert pt.state["step"] == int(jt.state["step"]) == 4
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        assert set(g) == set(w)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    ref = params_from_reference(cfg, jax.tree.map(np.asarray, jt.state["params"]))
    for name, t in pt.state["params"].state_dict().items():
        np.testing.assert_allclose(t.numpy(), ref[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_bf16_trainer_keeps_bf16_weights_and_fp32_state():
    pt = _port_trainer(microbatches=2)
    pt.init(0)
    hist = pt.train(2, log_every=0)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert {t.dtype for t in pt.state["params"].parameters()} == {torch.bfloat16}
    assert pt.state["opt_state"]["m"]["blocks"]["attn"]["wq"].shape == (2, 64, 4, 16)
    assert pt.state["opt_state"]["v"]["embed"].dtype == torch.float32


def test_restart_continues_identically(tmp_path):
    """train(4) + save + a fresh Trainer's restore + train(4) == train(8),
    weights and losses bit for bit."""
    a = _port_trainer(str(tmp_path / "x"), every=4)
    a.init()
    hist_a = a.train(8, log_every=0)
    b = _port_trainer(str(tmp_path / "y"), every=4)
    b.init()
    b.train(4, log_every=0)
    c = _port_trainer(str(tmp_path / "y"))
    assert c.restore() and c.state["step"] == 4 and c.data.step == 4
    hist_c = c.train(4, log_every=0)
    assert [h["loss"] for h in hist_c] == [h["loss"] for h in hist_a[4:]]
    sa, sc = a.state["params"].state_dict(), c.state["params"].state_dict()
    assert all(torch.equal(sa[k], sc[k]) for k in sa)
    assert all(torch.equal(x, y) for x, y in zip(
        jax.tree.leaves(a.state["opt_state"]), jax.tree.leaves(c.state["opt_state"])))


def test_failure_hook_crash_and_recover(tmp_path):
    class Boom(RuntimeError):
        pass

    tr = _port_trainer(str(tmp_path), every=3)
    tr.init()

    def hook(step):
        if step == 7:
            raise Boom("node died")

    tr.failure_hook = hook
    with pytest.raises(Boom):
        tr.train(20, log_every=0)
    assert ckpt.latest_step(str(tmp_path)) == 6
    tr2 = _port_trainer(str(tmp_path))
    assert tr2.restore() and tr2.state["step"] == 6
    tr2.train(2, log_every=0)
    assert tr2.state["step"] == 8
    assert not _port_trainer(str(tmp_path / "empty")).restore()
    with pytest.raises(RuntimeError, match="init"):
        _port_trainer().train(1)


def test_straggler_detection():
    import time as _t

    tr = _port_trainer()
    tr.straggler_factor = 1.5
    tr.init()
    orig = tr._step_fn
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 9:
            # Twice the threshold over the slowest step so far, so the step
            # stands out however loaded the host is.
            _t.sleep(2 * tr.straggler_factor * max(tr.step_times))
        return orig(state, batch)

    tr._step_fn = slow_step
    logged = []
    tr.train(10, log_every=0, log_fn=logged.append)
    assert tr.stragglers >= 1 and any("straggler" in m for m in logged)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "ck")
    assert launch_train.main(["--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
                              "--ckpt-dir", d, "--ckpt-every", "2"]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and ckpt.list_steps(d) == [2, 3]
    assert launch_train.main(["--device", "cpu", "--steps", "1", "--batch", "4", "--seq", "16",
                              "--ckpt-dir", d, "--resume"]) == 0
    assert "resumed at step 3" in capsys.readouterr().out and ckpt.latest_step(d) == 4
    assert launch_train.main(["--device", "cpu", "--arch", "mamba2-2.7b", "--steps", "1",
                              "--batch", "2", "--seq", "16"]) == 0


def test_launcher_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--steps", "1"])
