"""The port's training loss against the JAX package: ``cross_entropy_loss``
(value, metrics, gradient) and ``Model.loss`` for the six families at
``reduced_config`` (float32 at 1e-4 against the reference's jnp path;
qwen3, mamba2 and zamba2 within 5e-3 of the reference's
``use_pallas=True`` loss, as ``tests/test_kernels.py`` holds the
reference's two paths).  The reference's weights are carried across by
``convert.params_from_reference``.  bf16 and the remat policies:
``tests/test_torch_loss_bf16.py``.
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
from repro.models import build_model as jbuild_model
from repro.models.common import cross_entropy_loss as jcross_entropy_loss
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.models import build_model
from repro_torch.models.common import cross_entropy_loss

FAMILIES = ["qwen3-32b", "grok-1-314b", "qwen2-vl-2b", "mamba2-2.7b", "zamba2-2.7b",
            "whisper-tiny"]


def _cfgs(arch, **kw):
    jcfg, cfg = jreduced_config(jget_config(arch)), reduced_config(get_config(arch))
    if cfg.ssm is not None:  # chunks of 16 over the 32-token batches, as the SSM tests use
        kw["ssm"] = dataclasses.replace(cfg.ssm, chunk=16)
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def _pair(arch, jp=None, **kw):
    """(jax model, jax params, port model, port params, batch) with the same
    weights; the batch is the reference pipeline's (2 x 32 tokens)."""
    jcfg, cfg = _cfgs(arch, **kw)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0)) if jp is None else jp
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    params.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, m, params, jmake_batch(jcfg, 2, 32, seed=1)


def _np_batch(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("vpad", [256, 384])
def test_cross_entropy_loss_value_metrics_and_gradient(vpad):
    """Padded-vocab mask, fp32 logsumexp, z-loss, the four metrics and the
    gradient against ``jax.grad``; rows with tied maxima take the first
    index for ``accuracy`` (``jnp.argmax``'s rule)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, vpad)).astype(np.float32) * 3
    logits[0, :, 5] = logits[0, :, 9] = 50.0  # a tie: index 5 wins
    labels = rng.integers(0, 256, size=(3, 7)).astype(np.int32)
    labels[0, :3] = 5
    labels[0, 3:] = 9
    (jl, jm), jg = jax.value_and_grad(
        lambda x: jcross_entropy_loss(x, jnp.asarray(labels), 256), has_aux=True)(
            jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss, metrics = cross_entropy_loss(x, torch.from_numpy(labels), 256)
    (g,) = torch.autograd.grad(loss, x)
    assert set(metrics) == set(jm) == {"loss", "nll", "z_loss", "accuracy"}
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]), rtol=1e-6,
                                   atol=1e-7)
    assert float(metrics["accuracy"]) == float(jm["accuracy"])
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-8)
    assert not g[..., 256:].any()  # the padded vocab takes no gradient


def test_cross_entropy_loss_bf16_logits_accumulate_in_fp32():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 5, 256)).astype(np.float32)
    labels = rng.integers(0, 256, size=(2, 5)).astype(np.int32)
    jl, _ = jcross_entropy_loss(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels), 256)
    t = torch.from_numpy(logits).to(torch.bfloat16)
    loss, _ = cross_entropy_loss(t, torch.from_numpy(labels), 256)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_loss_float32_matches_reference(arch):
    jm, jp, m, params, batch = _pair(arch, dtype="float32")
    jl, jmet = jm.loss(jp, batch)
    loss, metrics = m.loss(params, _np_batch(batch))
    assert set(metrics) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-32b", "mamba2-2.7b", "zamba2-2.7b"])
def test_model_loss_matches_reference_kernel_path(arch):
    """The port's loss (the kernels' plain versions on the CPU) against the
    reference's ``use_pallas=True`` loss (its Pallas kernels in interpret
    mode), within ``tests/test_kernels.py``'s 5e-3, on its batch."""
    jcfg, cfg = jreduced_config(jget_config(arch)), reduced_config(get_config(arch))
    jm = jbuild_model(jcfg, use_pallas=True)
    jp = jm.init(jax.random.key(0))
    batch = {"tokens": jax.random.randint(jax.random.key(1), (2, 32), 0, cfg.vocab),
             "labels": jax.random.randint(jax.random.key(2), (2, 32), 0, cfg.vocab)}
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    params.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, jp)))
    jl = float(jm.loss(jp, batch)[0])
    assert abs(float(m.loss(params, _np_batch(batch))[0]) - jl) < 5e-3


def test_loss_records_autograd_but_serving_does_not():
    _, cfg = _cfgs("qwen3-32b", dtype="float32")
    m = build_model(cfg, device="cpu")
    params = m.init(0).requires_grad_(True)
    batch = _np_batch(jmake_batch(jreduced_config(jget_config("qwen3-32b")), 2, 8))
    assert m.loss(params, batch)[0].requires_grad
    logits, _ = m.prefill(params, {"tokens": batch["tokens"]}, 16)
    assert not logits.requires_grad
