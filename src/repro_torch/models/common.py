"""Shared model components: the seeded initializer, RMS norm, rotary
embeddings (with Qwen2-VL's M-RoPE), the SwiGLU MLP, the training loss and
activation checkpointing (the port's copy of ``repro.models.common``).

Layers are plain functions ``f(p, x, ...)`` over a parameter mapping ``p``:
a dict of tensors or a ``ParamModule`` (an ``nn.Module`` whose parameters
read as ``p["name"]``), so the same code runs the model's modules and the
tests' dicts.  The reference's ``lax.scan`` over stacked layers is a Python
loop over a ``ModuleList`` in the port.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .sharding import all_max, all_min, fanout, group_size, psum

__all__ = [
    "DTYPES",
    "Initializer",
    "ParamModule",
    "rms_norm",
    "rope_frequencies",
    "apply_rope",
    "swiglu",
    "cross_entropy_loss",
    "remat",
]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


class Initializer:
    """Seeded parameter initializer: draws from an explicit
    ``torch.Generator`` on the target device, with the reference's std
    rules (fan-in = ``shape[-2]``, or ``shape[-1]`` for a vector).  Its
    numbers differ from ``jax.random``'s for the same seed; tests carry the
    reference's weights across instead (``convert.params_from_reference``).
    """

    def __init__(self, seed: int, dtype: torch.dtype, device: torch.device):
        self.device = torch.device(device)
        # the meta device (shapes and dtypes only, ``launch.specs``) draws nothing
        self.gen = (None if self.device.type == "meta"
                    else torch.Generator(device=device).manual_seed(int(seed)))
        self.dtype = dtype

    def normal(self, shape: Sequence[int], stddev: float | None = None) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(tuple(shape), dtype=self.dtype, device=self.device)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = stddev if stddev is not None else 1.0 / math.sqrt(fan_in)
        x = torch.randn(tuple(shape), generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return x.mul_(std).to(self.dtype)  # in place: one float32 temporary, not two

    def normal_stack(self, shape: Sequence[int], stddev: float | None = None) -> torch.Tensor:
        """``normal(shape)`` drawn one slice of the leading axis at a time
        into a tensor of the target dtype, so that the float32 temporary is
        one slice (an expert's (d, fe) weight), not the whole stack (kimi's
        w1 would need 22.5 GB).  The std rule is the same: fan-in =
        ``shape[-2]``."""
        out = torch.empty(tuple(shape), dtype=self.dtype, device=self.device)
        for i in range(shape[0] if self.gen is not None else 0):
            out[i] = self.normal(shape[1:], stddev)
        return out

    def zeros(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)

    def ones(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=self.dtype, device=self.device)


class ParamModule(nn.Module):
    """An ``nn.Module`` that holds frozen parameters (inference only) and
    reads them, and its submodules, as ``p["name"]``.  A nested dict of
    tensors becomes a nested ``ParamModule``."""

    def __init__(self, **tree):
        super().__init__()
        for name, t in tree.items():
            if isinstance(t, dict):
                self.add_module(name, ParamModule(**t))
            else:
                self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim/2,), float32."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, int, int] | None = None) -> torch.Tensor:
    """Rotate ``x`` (b, s, h, hd) by ``positions``: (b, s), or (3, b, s) for
    M-RoPE, whose three streams (temporal, height, width) rotate the
    consecutive slices of the half-dim that ``mrope_sections`` sizes (the
    reference's slicing: a slice past hd/2 is cut short, so at hd 16 only
    the temporal stream is reached)."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, device=x.device)
    if mrope_sections is None:
        ang = positions[..., None].float() * inv  # (b, s, hd/2)
    else:
        if positions.dim() != 3:
            raise ValueError(f"M-RoPE needs (3, b, s) positions, got {tuple(positions.shape)}")
        parts, start = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(positions[i][..., None].float() * inv[start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)  # (b, s, hd/2)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
           group=None) -> torch.Tensor:
    """SwiGLU MLP: (x@w1 · silu(x@w3)) @ w2.  On a mesh, ``group`` is the
    model axis's when w1 and w3 hold this rank's slice of the hidden units
    ("ff") and w2 its rows: the input enters through ``fanout`` and the
    partial outputs meet in a ``psum`` ("seq_sp", "embed"); with no group
    both return their input."""
    x = fanout(x, group)
    h = torch.einsum("bsd,df->bsf", x, w1)
    g = torch.einsum("bsd,df->bsf", x, w3)
    return psum(torch.einsum("bsf,fd->bsd", h * F.silu(g), w2), group)


# ------------------------------------------------------------------------------
# Loss
# ------------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                       z_loss: float = 1e-4, group=None
                       ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token cross-entropy over (b, s, vocab_padded) logits and (b, s)
    labels, in fp32: the padded vocab masked to -1e30, the log-sum-exp, the
    gold logit, z-loss ``z_loss * lse^2``.  Returns (loss, metrics): the
    differentiable mean loss, and its ``loss``, ``nll``, ``z_loss`` and
    ``accuracy`` (argmax over the masked logits, the first index among
    ties, as ``jnp.argmax``), all but ``loss`` detached.  With a ``group``
    of more than one rank the logits are this rank's slice of the
    vocabulary ("vocab" -> model, rank r holding columns r * v_loc ..):
    ``_vocab_split_loss``."""
    if group_size(group) > 1:
        return _vocab_split_loss(logits, labels, vocab, group, z_loss)
    logits = logits.float()
    vpad = logits.shape[-1]
    if vpad > vocab:
        pad = torch.arange(vpad, device=logits.device) >= vocab
        logits = logits.masked_fill(pad, -1e30)
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    nll = lse - gold
    zl = z_loss * lse.square()
    loss = (nll + zl).mean()
    with torch.no_grad():
        acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "nll": nll.detach().mean(), "z_loss": zl.detach().mean(),
                  "accuracy": acc}


def _vocab_split_loss(logits: torch.Tensor, labels: torch.Tensor, vocab: int, group,
                      z_loss: float) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``cross_entropy_loss`` over vocab-split logits: the same quantities,
    each reduced over the group (the max before the exponent is a
    constant, outside the gradient); the padded vocabulary is masked by
    each shard's global columns, and the argmax takes the lowest column
    among the shards' maxima."""
    import torch.distributed as dist

    logits = logits.float()
    v_loc = logits.shape[-1]
    lo = dist.get_rank(group) * v_loc
    col = lo + torch.arange(v_loc, device=logits.device)
    logits = logits.masked_fill(col >= vocab, -1e30)
    labels = labels.long()
    m = all_max(logits.amax(dim=-1), group)
    lse = m + torch.log(psum(torch.exp(logits - m[..., None]).sum(dim=-1), group))
    hit = labels[..., None] == col
    gold = psum(torch.where(hit, logits, 0.0).sum(dim=-1), group)
    nll = lse - gold
    zl = z_loss * lse.square()
    loss = (nll + zl).mean()
    with torch.no_grad():
        vmax, arg = logits.max(dim=-1)
        best = all_max(vmax, group)
        cand = torch.where(vmax == best, arg + lo, torch.iinfo(torch.int64).max)
        acc = (all_min(cand, group) == labels).float().mean()
    return loss, {"loss": loss, "nll": nll.detach().mean(), "z_loss": zl.detach().mean(),
                  "accuracy": acc}


# ------------------------------------------------------------------------------
# Activation checkpointing (the reference's ``jax.checkpoint`` policies)
# ------------------------------------------------------------------------------

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of products
    without a batch dimension (``mm``, and ``bmm`` over a batch of one, as
    ``torch.einsum`` lowers a weight product), recompute the rest."""
    if op in _MATMULS or (op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under activation checkpointing: ``"none"`` runs it as it is;
    ``"dots"`` keeps its weight products' outputs and recomputes the rest in
    the backward pass (a selective checkpoint); any other policy
    (``"full"``) keeps only its inputs.  Non-reentrant
    ``torch.utils.checkpoint``: the recompute runs the same ops, so the
    numbers do not change."""
    if policy == "none":
        return fn
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _save_matmuls)
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=ctx)
    return functools.partial(checkpoint, fn, use_reentrant=False)
