"""The port's training loss in bf16 and under activation checkpointing, on
the CPU against the JAX package (``tests/test_torch_loss.py`` holds the
float32 loss): the bf16 training logits of the six families no farther
from the reference's float32 logits than 3x the reference's own bf16
logits are, and the four remat policies giving equal numbers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.data import make_batch as jmake_batch
from repro.models import encdec as jencdec
from repro.models import hybrid as jhybrid
from repro.models import transformer as jtransformer
from repro_torch.models import build_model, encdec, hybrid, transformer, zoo
from test_torch_loss import FAMILIES, _cfgs, _np_batch, _pair


def _jlogits(jm, jp, batch):
    """The reference's training logits at the text positions, float32."""
    cfg, rules = jm.cfg, jm.rules
    f = cfg.family
    if f in ("dense", "moe", "vlm"):
        out = jtransformer.dense_train_logits(jp, batch, cfg, rules)[0]
        out = out[:, batch["img_embeds"].shape[1]:] if "img_embeds" in batch else out
    elif f == "ssm":
        out = jnp.einsum("bsd,dv->bsv", jm._ssm_forward(jp, batch)[0], jp["head"])
    elif f == "hybrid":
        out = jhybrid.hybrid_train_logits(jp, batch, cfg, rules)
    else:
        out = jencdec.encdec_train_logits(jp, batch, cfg, rules)
    return np.asarray(out, np.float32)


def _logits(m, params, batch):
    """The port's training logits at the text positions, float32."""
    cfg = m.cfg
    b = {k: (torch.from_numpy(np.asarray(v)).long() if k in ("tokens", "labels")
             else zoo._tensor(np.asarray(v), m.device)) for k, v in batch.items()}
    with torch.no_grad():
        if cfg.family in ("dense", "moe", "vlm"):
            out = transformer.dense_train_logits(params, b, cfg)[0]
            out = out[:, b["img_embeds"].shape[1]:] if "img_embeds" in b else out
        elif cfg.family == "ssm":
            out = zoo._ssm_train_logits(params, b, cfg)
        elif cfg.family == "hybrid":
            out = hybrid.hybrid_train_logits(params, b, cfg)
        else:
            out = encdec.encdec_train_logits(params, b, cfg)
    return out.float().numpy()


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_loss_bf16_within_the_references_own_error(arch):
    """bf16 weights (the float32 ones rounded): the port's bf16 training
    logits no farther from the reference's float32 logits than 3x the
    reference's own bf16 logits are (relative Frobenius; XLA and PyTorch
    round bf16 at other places), the rule of ``tests/test_torch_dense.py``;
    and the bf16 loss finite (a mean over the positions, whose rounding
    errors cancel by chance, so the scalar takes no 3x rule)."""
    jm32, jp32, _, _, batch = _pair(arch, dtype="float32")
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp32)
    jm16, _, m16, p16, _ = _pair(arch, jp=jp16, dtype="bfloat16")
    ref32 = _jlogits(jm32, jp32, batch)
    ref_err = _rel(_jlogits(jm16, jp16, batch), ref32)
    got_err = _rel(_logits(m16, p16, batch), ref32)
    assert got_err <= 3 * ref_err, (got_err, ref_err)
    assert np.isfinite(float(m16.loss(p16, _np_batch(batch))[0].detach()))


@pytest.mark.parametrize("arch", ["qwen3-32b", "grok-1-314b", "zamba2-2.7b", "whisper-tiny"])
def test_remat_policies_change_no_number(arch):
    """"none", "full", "dots" and "names" give the same loss and the same
    gradients, bit for bit (the recompute runs the same ops)."""
    _, cfg = _cfgs(arch, dtype="float32")
    out = {}
    for policy in ("none", "full", "dots", "names"):
        m = build_model(dataclasses.replace(cfg, remat=policy), device="cpu")
        params = m.init(0).requires_grad_(True)
        batch = jmake_batch(jreduced_config(jget_config(arch)), 2, 16, seed=2)
        loss, _ = m.loss(params, _np_batch(batch))
        out[policy] = (loss.detach(), torch.autograd.grad(loss, list(params.parameters())))
    for policy in ("full", "dots", "names"):
        assert torch.equal(out[policy][0], out["none"][0]), policy
        for g, g0 in zip(out[policy][1], out["none"][1]):
            assert torch.equal(g, g0), policy
