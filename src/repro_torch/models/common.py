"""Shared model components: the seeded initializer, RMS norm, rotary
embeddings and the SwiGLU MLP (the port's copy of ``repro.models.common``).

Layers are plain functions ``f(p, x, ...)`` over a parameter mapping ``p``:
a dict of tensors or a ``ParamModule`` (an ``nn.Module`` whose parameters
read as ``p["name"]``), so the same code runs the model's modules and the
tests' dicts.  The reference's ``lax.scan`` over stacked layers is a Python
loop over a ``ModuleList`` in the port.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "DTYPES",
    "Initializer",
    "ParamModule",
    "rms_norm",
    "rope_frequencies",
    "apply_rope",
    "swiglu",
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
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.dtype = dtype
        self.device = device

    def normal(self, shape: Sequence[int], stddev: float | None = None) -> torch.Tensor:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = stddev if stddev is not None else 1.0 / math.sqrt(fan_in)
        x = torch.randn(tuple(shape), generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return x.mul_(std).to(self.dtype)  # in place: one float32 temporary, not two

    def zeros(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)

    def ones(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=self.dtype, device=self.device)


class ParamModule(nn.Module):
    """An ``nn.Module`` that holds frozen parameters (inference only) and
    reads them, and its submodules, as ``p["name"]``."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
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


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` (b, s, h, hd) by ``positions`` (b, s) (no M-RoPE: the
    ported families do not use it)."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, device=x.device)
    ang = positions[..., None].float() * inv  # (b, s, hd/2)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (x@w1 · silu(x@w3)) @ w2."""
    h = torch.einsum("bsd,df->bsf", x, w1)
    g = torch.einsum("bsd,df->bsf", x, w3)
    return torch.einsum("bsf,fd->bsd", h * F.silu(g), w2)
