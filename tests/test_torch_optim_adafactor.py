"""Adafactor's update against the JAX package's on the same parameters,
gradients and state (``tests/test_torch_optim.py`` holds the rules: 4
float32 ulps for Adafactor's parameters, 2 for its state, 1 bf16 ulp),
also at a 16-layer config where the stacked 1-D leaves factor across the
layers."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import reference_leaves
from repro_torch.models import build_model
from repro_torch.optim import optimizers as opt
from repro_torch.optim.optimizers import tree_get
from test_torch_optim import _run


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["grok-1-314b", "whisper-tiny"])
def test_adafactor_update_matches_reference(arch, dtype):
    _run("adafactor", arch, dtype)


def test_adafactor_factors_stacked_1d_leaves_at_16_layers():
    """At 16 layers a stack of per-layer scales, (16, d), is factored: its
    row statistic spans the layers and its column statistic the width,
    and the update's RMS clip spans the whole stack, as the reference's."""
    cfg, leaves, state = _run("adafactor", "qwen3-32b", "float32", n_layers=16)
    ln1 = tree_get(state["stats"], "blocks/ln1")
    assert set(ln1) == {"vr", "vc"} and ln1["vr"].shape == (16,) and ln1["vc"].shape == (64,)
    assert set(tree_get(state["stats"], "final_norm")) == {"v"}


def _whole_leaf_adafactor(grads, state, leaves, step, lr, decay=0.8, eps=1e-30):
    """Adafactor's update on each leaf whole, as the port ran it before its
    update went slice by slice (the arithmetic the slices must repeat)."""
    grads, gnorm = opt.clip_by_global_norm(grads, 1.0)
    t = torch.tensor(step, dtype=torch.int32).float() + 1.0
    beta = 1.0 - torch.pow(t, -decay)
    lr_t = lr(torch.tensor(step, dtype=torch.int32))
    with torch.no_grad():
        for leaf, gs in zip(leaves, grads):
            st = tree_get(state["stats"], leaf.path)
            g32 = torch.stack([g.float() for g in gs]) if leaf.stacked else gs[0].float()
            g2 = torch.square(g32) + eps
            if "vr" in st:
                r, c = len(leaf.shape) - 2, len(leaf.shape) - 1
                st["vr"].copy_(beta * st["vr"] + (1 - beta) * g2.mean(dim=c))
                st["vc"].copy_(beta * st["vc"] + (1 - beta) * g2.mean(dim=r))
                denom = torch.clamp(st["vr"].mean(dim=-1, keepdim=True), min=eps)
                rms = torch.sqrt((st["vr"] / denom).unsqueeze(c) * st["vc"].unsqueeze(r))
            else:
                st["v"].copy_(beta * st["v"] + (1 - beta) * g2)
                rms = torch.sqrt(st["v"])
            u = g32 / torch.clamp(rms, min=1e-12)
            u_rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(u_rms, min=1.0)
            p32 = leaf.stack()
            new = p32 - (lr_t * u + lr_t * 0.0 * p32)
            for j, p in enumerate(leaf.tensors):
                p.copy_(new[j] if leaf.stacked else new)
    return gnorm


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


@pytest.mark.parametrize("slice_elems", [64, 4096, opt.SLICE_ELEMS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,n_layers", [("grok-1-314b", 2), ("kimi-k2-1t-a32b", 1),
                                           ("qwen3-32b", 16)])
def test_sliced_update_equals_the_whole_leaf_bit_for_bit(arch, n_layers, dtype, slice_elems,
                                                         monkeypatch):
    """The update slice by slice (``SLICE_ELEMS`` cut to 64 and 4096
    elements, so every matrix of a reduced leaf is a slice of its own or a
    few of them) gives the parameters and statistics of the update on each
    leaf whole, bit for bit, a step after warm-up with a clip that scales:
    the reduced MoE's expert stacks, kimi's shared expert, a 16-layer
    config's stacked 1-D scales."""
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype, n_layers=n_layers)
    params = build_model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(7)
    twin = copy.deepcopy(params)
    sched = opt.cosine_schedule(3e-3, 2, 20)
    po = opt.adafactor(lr=sched)
    leaves, twin_leaves = reference_leaves(cfg, params), reference_leaves(cfg, twin)
    state = po.init(leaves)
    for st in jax.tree.leaves(state):  # statistics as after a few steps
        st.copy_(torch.from_numpy(np.abs(rng.normal(size=tuple(st.shape))) * 1e-3))
    twin_state = jax.tree.map(torch.clone, state)
    grads = [[torch.from_numpy(rng.normal(size=tuple(t.shape)) * 0.5).to(t.dtype)
              for t in leaf.tensors] for leaf in leaves]
    twin_grads = [[g.clone() for g in gs] for gs in grads]
    monkeypatch.setattr(opt, "SLICE_ELEMS", slice_elems)
    stats = po.update(grads, state, leaves, 3)
    gnorm = _whole_leaf_adafactor(twin_grads, twin_state, twin_leaves, 3, sched)
    assert float(gnorm) > 1.0 and torch.equal(stats["grad_norm"], gnorm)  # the clip scales
    sd, want = params.state_dict(), twin.state_dict()
    assert all(torch.equal(_bits(sd[k]), _bits(want[k])) for k in sd)
    assert all(torch.equal(_bits(a), _bits(b))
               for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(twin_state)))
