"""Optimizers: AdamW (fp32 states) and Adafactor (factored second moments),
the port's copy of ``repro.optim.optimizers``.

    opt = make_optimizer(name, lr, total_steps, warmup)
    state = opt.init(leaves)
    stats = opt.update(grads, state, leaves, step)

The reference updates a pytree whose per-layer leaves are stacked along a
leading layer axis.  The port keeps its layers unstacked (``blocks.<i>``),
so its optimizers take the reference's leaves as ``Leaf`` objects: a
reference tree path and the port's tensors that make it up (one per layer
of a stacked leaf, in layer order; ``convert.reference_leaves`` builds
them).  ``grads`` lists, for each leaf, one gradient per tensor.  The
optimizer state is kept in the reference's tree shape: nested dicts of
stacked fp32 tensors (what a checkpoint writes).

Updates happen in place (the reference returns new trees and donates the
old ones): the parameters, the state and, for the clip, the gradients.
AdamW is elementwise, so it runs layer by layer on views of the stacked
state.  Adafactor is not: it factors the last two dims of the *stacked*
leaf (a stack of 1-D scales, (L, d), is factored once L >= 16) and clips
the update by its RMS over the whole stacked leaf, so it stacks each
leaf's gradients and parameters and updates them as one.

Scalars (the step's learning rate, bias corrections, the clip scale) are
0-d fp32 tensors on the parameters' device, so an update never waits for
the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

__all__ = ["Leaf", "Optimizer", "adamw", "adafactor", "clip_by_global_norm", "cosine_schedule",
           "global_norm", "make_optimizer", "tree_get", "tree_set"]


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the reference's tree: its path (``"blocks/attn/wq"``) and
    the port's tensors behind it (one per layer when ``stacked``)."""

    path: str
    tensors: tuple
    stacked: bool

    @property
    def shape(self) -> tuple[int, ...]:
        """The reference leaf's shape (the layer axis first when stacked)."""
        inner = tuple(self.tensors[0].shape)
        return (len(self.tensors), *inner) if self.stacked else inner

    def stack(self) -> torch.Tensor:
        """The reference leaf as one tensor, in fp32."""
        if self.stacked:
            return torch.stack([t.detach().float() for t in self.tensors])
        return self.tensors[0].detach().float()


def tree_get(tree: dict, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def tree_set(tree: dict, path: str, value) -> None:
    *keys, last = path.split("/")
    for key in keys:
        tree = tree.setdefault(key, {})
    tree[last] = value


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def global_norm(grads: list) -> torch.Tensor:
    """sqrt of the sum over every leaf of its sum of squares, in fp32."""
    per_leaf = [sum(torch.sum(torch.square(g.float())) for g in gs) for gs in grads]
    return torch.sqrt(torch.sum(torch.stack(per_leaf)))


def clip_by_global_norm(grads: list, max_norm: float) -> tuple[list, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / max(norm, 1e-9)) in fp32 and
    round back to its own dtype, in place.  Returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with torch.no_grad():
        for gs in grads:
            for g in gs:
                if g.dtype == torch.float32:
                    g.mul_(scale)
                else:
                    g.copy_(g.float() * scale)
    return grads, norm


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; fp32, as the reference computes it."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * torch.clamp((step + 1.0) / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return lr


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[list], Any]
    update: Callable[[list, Any, list, Any], dict]
    name: str = "opt"


def _lr_fn(lr) -> Callable[[torch.Tensor], torch.Tensor]:
    return lr if callable(lr) else (lambda s: _f32(lr, s.device))


def _step(step, device) -> torch.Tensor:
    return step.to(device) if isinstance(step, torch.Tensor) else torch.tensor(
        int(step), dtype=torch.int32, device=device)


def adamw(lr: Callable | float = 3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(leaves: list) -> dict:
        state: dict = {"m": {}, "v": {}}
        for leaf in leaves:
            dev = leaf.tensors[0].device
            for key in ("m", "v"):
                tree_set(state[key], leaf.path,
                         torch.zeros(leaf.shape, dtype=torch.float32, device=dev))
        return state

    def update(grads: list, state: dict, leaves: list, step) -> dict:
        dev = leaves[0].tensors[0].device
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        step = _step(step, dev)
        t = step.float() + 1.0
        lr_t = lr_fn(step)
        bc1 = 1.0 - torch.pow(_f32(b1, dev), t)
        bc2 = 1.0 - torch.pow(_f32(b2, dev), t)
        with torch.no_grad():
            for leaf, gs in zip(leaves, grads):
                m_all, v_all = tree_get(state["m"], leaf.path), tree_get(state["v"], leaf.path)
                for j, (p, g) in enumerate(zip(leaf.tensors, gs)):
                    m, v = (m_all[j], v_all[j]) if leaf.stacked else (m_all, v_all)
                    g32 = g.float()
                    m.mul_(b1).add_(g32 * (1 - b1))
                    v.mul_(b2).add_(torch.square(g32).mul_(1 - b2))
                    den = torch.sqrt(v / bc2).add_(eps)
                    upd = (m / bc1).div_(den)
                    del den
                    p32 = p.float()
                    upd.add_(weight_decay * p32).mul_(lr_t)
                    if p.dtype == torch.float32:
                        p.sub_(upd)
                    else:
                        p.copy_(p32.sub_(upd))
        return {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init=init, update=update, name="adamw")


def _factored_dims(shape) -> tuple[int, int] | None:
    """Last two dims to factor over (None => keep full v)."""
    if len(shape) < 2:
        return None
    return len(shape) - 2, len(shape) - 1


def adafactor(lr: Callable | float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_norm: float = 1.0, weight_decay: float = 0.0,
              min_dim_size_to_factor: int = 16) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018) without momentum, factored v only,
    on each reference leaf as a whole (its layers stacked)."""
    lr_fn = _lr_fn(lr)

    def _factored(shape) -> bool:
        fd = _factored_dims(shape)
        return fd is not None and min(shape[fd[0]], shape[fd[1]]) >= min_dim_size_to_factor

    def init(leaves: list) -> dict:
        stats: dict = {}
        for leaf in leaves:
            shape = leaf.shape
            dev = leaf.tensors[0].device
            zeros = lambda s: torch.zeros(s, dtype=torch.float32, device=dev)
            if _factored(shape):
                r, c = _factored_dims(shape)
                st = {"vr": zeros(shape[:c] + shape[c + 1:]), "vc": zeros(shape[:r] + shape[r + 1:])}
            else:
                st = {"v": zeros(shape)}
            tree_set(stats, leaf.path, st)
        return {"stats": stats}

    def update(grads: list, state: dict, leaves: list, step) -> dict:
        dev = leaves[0].tensors[0].device
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        step = _step(step, dev)
        t = step.float() + 1.0
        beta = 1.0 - torch.pow(t, -decay)
        lr_t = lr_fn(step)
        with torch.no_grad():
            for leaf, gs in zip(leaves, grads):
                st = tree_get(state["stats"], leaf.path)
                g32 = torch.stack([g.float() for g in gs]) if leaf.stacked else gs[0].float()
                g2 = torch.square(g32) + eps
                if "vr" in st:
                    r, c = _factored_dims(leaf.shape)
                    st["vr"].copy_(beta * st["vr"] + (1 - beta) * g2.mean(dim=c))
                    st["vc"].copy_(beta * st["vc"] + (1 - beta) * g2.mean(dim=r))
                    denom = torch.clamp(st["vr"].mean(dim=-1, keepdim=True), min=eps)
                    rms = torch.sqrt((st["vr"] / denom).unsqueeze(c) * st["vc"].unsqueeze(r))
                else:
                    st["v"].copy_(beta * st["v"] + (1 - beta) * g2)
                    rms = torch.sqrt(st["v"])
                del g2
                u = g32 / torch.clamp(rms, min=1e-12)
                del rms
                u_rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
                u = u / torch.clamp(u_rms, min=1.0)
                p32 = leaf.stack()
                new = p32 - (lr_t * u + lr_t * weight_decay * p32)
                for j, p in enumerate(leaf.tensors):
                    p.copy_(new[j] if leaf.stacked else new)
        return {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init=init, update=update, name="adafactor")


def make_optimizer(name: str, lr=None, total_steps: int = 10_000, warmup: int = 200) -> Optimizer:
    sched = cosine_schedule(lr or (3e-4 if name == "adamw" else 1e-3), warmup, total_steps)
    if name == "adamw":
        return adamw(lr=sched)
    if name == "adafactor":
        return adafactor(lr=sched)
    raise ValueError(name)
