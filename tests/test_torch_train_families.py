"""The port's ``Trainer`` against the JAX package's ``repro.train.Trainer``
for the families that ``tests/test_torch_train.py`` does not train, with
the same start weights (``convert.params_from_reference``), float32, 4
steps: per-step loss, grad norm and lr within a relative 1e-4, the final
weights within 1e-4 (``test_trainer_follows_the_reference``'s rule).

- reduced kimi-k2-1t-a32b: Adafactor, the shared expert, remat "full",
  2 microbatches;
- reduced qwen2-vl-2b: image embeddings before the text, three distinct
  M-RoPE position streams, remat "dots";
- reduced phi3-medium-14b at its own 40/10 heads, padded to 48/12, remat
  "dots".

Then the port alone, bf16: a restart from a checkpoint of reduced kimi and
qwen2-vl equals an uninterrupted run bit for bit (losses, weights and the
optimizer's state), as ``test_restart_continues_identically`` checks."""
import dataclasses

import jax
import jax.numpy as jnp
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
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import build_model, transformer
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer

SEQ, BATCH = 24, 4
# each family's cut: the config's own traits the reduced config drops
CUTS = {
    "kimi-k2-1t-a32b": dict(remat="full", microbatches=2),
    "qwen2-vl-2b": dict(remat="dots"),
    "phi3-medium-14b": dict(remat="dots", n_heads=40, n_kv_heads=10),
}


def _positions(b: int, s: int) -> np.ndarray:
    """(3, b, s) M-RoPE positions whose three streams differ."""
    i = np.arange(s)
    streams = np.stack([i, i // 2, i % 3 + i // 4]).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(streams[:, None], (3, b, s)))


def _with_positions(data, as_array):
    """``data.batch`` with the vlm's positions replaced by ``_positions``."""
    draw = data.batch

    def batch(i=None):
        out = draw(i)
        out["positions"] = as_array(_positions(*out["positions"].shape[1:]))
        return out

    data.batch = batch


def _port_trainer(arch, tmp=None, every=100, **kw):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **CUTS[arch], **kw)
    tr = Trainer(model=build_model(cfg, device="cpu"),
                 opt=make_optimizer(cfg.optimizer, lr=3e-3, total_steps=200, warmup=2),
                 data=SyntheticLM(cfg, DataConfig(seq_len=SEQ, global_batch=BATCH, seed=0)),
                 ckpt_dir=tmp, ckpt_every=every)
    if cfg.family == "vlm":
        _with_positions(tr.data, torch.from_numpy)
    return tr


@pytest.mark.parametrize("arch", list(CUTS))
def test_trainer_follows_the_reference(arch):
    jcfg = dataclasses.replace(jreduced_config(jget_config(arch)), dtype="float32",
                               **CUTS[arch])
    jt = JTrainer(model=jbuild_model(jcfg),
                  opt=jmake_optimizer(jcfg.optimizer, lr=3e-3, total_steps=200, warmup=2),
                  data=JSyntheticLM(jcfg, JDataConfig(seq_len=SEQ, global_batch=BATCH, seed=0)))
    if jcfg.family == "vlm":
        _with_positions(jt.data, jnp.asarray)
    jt.init(0)
    pt = _port_trainer(arch, dtype="float32")
    pt.init(0)
    cfg = pt.model.cfg
    assert cfg.optimizer == ("adafactor" if cfg.moe is not None else "adamw")
    if arch == "phi3-medium-14b":
        assert transformer.padded_dims(cfg)[:2] == (48, 12)
    pt.state["params"].load_state_dict(
        params_from_reference(cfg, jax.tree.map(np.asarray, jt.state["params"])))
    want = jt.train(4, log_every=0)
    got = pt.train(4, log_every=0)
    assert pt.state["step"] == int(jt.state["step"]) == 4
    for g, w in zip(got, want):
        assert g["step"] == w["step"] and set(g) == set(w)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    ref = params_from_reference(cfg, jax.tree.map(np.asarray, jt.state["params"]))
    for name, t in pt.state["params"].state_dict().items():
        np.testing.assert_allclose(t.numpy(), ref[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "qwen2-vl-2b"])
def test_restart_continues_identically(arch, tmp_path):
    """train(4) == train(2) + a checkpoint + a fresh Trainer's restore +
    train(2): losses, weights and optimizer state bit for bit."""
    a = _port_trainer(arch)
    a.init()
    hist_a = a.train(4, log_every=0)
    b = _port_trainer(arch, str(tmp_path), every=2)
    b.init()
    b.train(2, log_every=0)
    c = _port_trainer(arch, str(tmp_path))
    assert c.restore() and c.state["step"] == 2 and c.data.step == 2
    hist_c = c.train(2, log_every=0)
    assert [h["loss"] for h in hist_c] == [h["loss"] for h in hist_a[2:]]
    sa, sc = a.state["params"].state_dict(), c.state["params"].state_dict()
    assert all(torch.equal(sa[k], sc[k]) for k in sa)
    assert all(torch.equal(x, y) for x, y in zip(
        jax.tree.leaves(a.state["opt_state"]), jax.tree.leaves(c.state["opt_state"])))
