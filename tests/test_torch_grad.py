"""Gradients of the port's ``Model.loss``, float32, on the CPU (here the
dense and moe families; ``tests/test_torch_grad_families.py`` the vlm,
ssm, hybrid and encdec ones), against ``jax.grad`` of the reference's loss, with the reference's
weights and gradient tree carried across by
``convert.params_from_reference``.  Each leaf's relative Frobenius error is
at most 1e-4, except whisper-tiny's at 5e-3: its reduced encoder's
attention logits reach ~120 (no qk-norm; ``tests/test_torch_encdec.py``
holds its float32 logits at 1e-3 for the same reason), where float32
rounding in another summation order moves the sharp softmax's gradients by
up to ~2e-3 of their norm (the two packages' own float32 orders differ by
as much with XLA at its highest matmul precision).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.data import make_batch as jmake_batch
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference, reference_leaves
from repro_torch.models import build_model

TOL = {"whisper-tiny": 5e-3}


def _setup(arch, microbatch=2, **kw):
    jcfg = dataclasses.replace(jreduced_config(jget_config(arch)), dtype="float32", **kw)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32", **kw)
    if cfg.ssm is not None:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=16))
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=16))
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    params.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, m, params.requires_grad_(True), jmake_batch(jcfg, microbatch, 32, seed=1)


def check_gradients(arch):
    """The port's gradients of ``Model.loss`` against ``jax.grad``, leaf by
    leaf, and the loss."""
    jm, jp, m, params, batch = _setup(arch)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, batch)
    loss, _ = m.loss(params, {k: np.asarray(v) for k, v in batch.items()})
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()), allow_unused=True)
    ref = params_from_reference(m.cfg, jax.tree.map(np.asarray, jg))
    assert set(ref) == set(names)
    tol = TOL.get(arch, 1e-4)
    worst = {}
    for name, g in zip(names, grads):
        want = ref[name].float()
        g = torch.zeros_like(want) if g is None else g
        denom = float(want.norm())
        err = float((g - want).norm()) / denom if denom else float(g.norm())
        worst[name] = err
    bad = {k: v for k, v in worst.items() if not v <= tol}
    assert not bad, bad
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-32b", "phi3-medium-14b", "grok-1-314b",
                                  "kimi-k2-1t-a32b"])
def test_gradients_match_jax_grad(arch):
    check_gradients(arch)


def test_reference_leaves_follow_the_reference_tree():
    """The leaves the optimizers and checkpoints walk are the reference
    tree's, in its flatten order, each stacked leaf's layers in order."""
    jm, jp, m, params, _ = _setup("zamba2-2.7b")
    paths = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    leaves = reference_leaves(m.cfg, params)
    assert [leaf.path for leaf in leaves] == paths
    for leaf, (_, a) in zip(leaves, jax.tree_util.tree_flatten_with_path(jp)[0]):
        assert leaf.shape == a.shape, leaf.path
        assert torch.equal(leaf.stack(), torch.from_numpy(np.array(a))), leaf.path
