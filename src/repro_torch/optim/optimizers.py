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
the update by its RMS over the whole stacked leaf, so it keeps the
leaf's u whole and walks its layers and matrices in slices.

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


# the elements of one slice of Adafactor's update (of a factored leaf, a
# run of whole matrices along its leading axes; 256 MiB in fp32): its
# temporaries are a slice's, beside one fp32 copy of the leaf (u) and, for
# u's RMS, u squared
SLICE_ELEMS = 1 << 26


def _pieces(leaf: Leaf, gs: list, st: dict) -> list[tuple]:
    """(parameter, gradient, statistics) per part of the leaf that its
    factored statistics do not span: each layer of a stacked leaf with its
    rows of the stacked statistics, or the leaf whole.  A stack of 1-D
    scales, (L, d), is factored across its layers, so it comes as one
    stacked fp32 copy (tiny), which the caller copies back."""
    if not leaf.stacked:
        return [(leaf.tensors[0], gs[0], st)]
    if len(leaf.shape) == 2:
        return [(leaf.stack(), torch.stack([g.float() for g in gs]), st)]
    return [(p, g, {k: v[j] for k, v in st.items()})
            for j, (p, g) in enumerate(zip(leaf.tensors, gs))]


def _slices(shape: tuple, factored: bool) -> tuple[tuple[int, ...], list[slice]]:
    """A piece's shape as (rows, *inner) and the row ranges of its slices:
    whole matrices (the last two dims) when factored, else elements."""
    inner = tuple(shape[-2:]) if factored else ()
    rows = math.prod(shape[:-2]) if factored else math.prod(shape)
    step = max(1, SLICE_ELEMS // max(math.prod(inner), 1))
    return (rows, *inner), [slice(a, min(a + step, rows)) for a in range(0, rows, step)]


def adafactor(lr: Callable | float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_norm: float = 1.0, weight_decay: float = 0.0,
              min_dim_size_to_factor: int = 16) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018) without momentum, factored v only,
    on each reference leaf as a whole (its layers stacked).

    The update runs over slices of each leaf (``SLICE_ELEMS``), since a
    leaf may be most of the card: grok-1's expert w1 at one layer is
    (1, 8, 6144, 32768), 6.4 GB in fp32 a copy.  The factored statistics
    are means over a matrix's rows and columns, so each slice of whole
    matrices updates its own; the update's RMS spans the leaf, so u is
    kept whole (one fp32 copy) for it, and the parameters are updated
    after it in slices of ``SLICE_ELEMS`` elements.  Each element takes the
    same operations as on the leaf whole."""
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

    def leaf_u(pieces: list, factored: bool, beta: torch.Tensor) -> torch.Tensor:
        """The leaf's u = g / rms, piece by piece and slice by slice,
        updating the statistics in place: (pieces, rows, *inner) fp32, the
        update's one allocation the size of the leaf."""
        shape, cuts = _slices(tuple(pieces[0][0].shape), factored)
        u = torch.empty((len(pieces), *shape), dtype=torch.float32, device=pieces[0][0].device)
        for i, (_, g, st) in enumerate(pieces):
            g = g.reshape(shape)
            if factored:
                vr, vc = st["vr"].reshape(shape[:2]), st["vc"].reshape(shape[0], shape[2])
            else:
                v = st["v"].reshape(shape)
            for cut in cuts:
                # u's slice holds g^2 + eps, then rms, then u
                g32, ui = g[cut].float(), u[i, cut]
                g2 = torch.square(g32, out=ui).add_(eps)
                if factored:
                    vr[cut] = beta * vr[cut] + (1 - beta) * g2.mean(dim=-1)
                    vc[cut] = beta * vc[cut] + (1 - beta) * g2.mean(dim=-2)
                    denom = torch.clamp(vr[cut].mean(dim=-1, keepdim=True), min=eps)
                    torch.mul((vr[cut] / denom).unsqueeze(-1), vc[cut].unsqueeze(-2), out=ui)
                    ui.sqrt_()
                else:
                    v[cut] = beta * v[cut] + (1 - beta) * g2
                    torch.sqrt(v[cut], out=ui)
                torch.div(g32, ui.clamp_(min=1e-12), out=ui)
        return u

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
                factored = "vr" in st
                pieces = _pieces(leaf, gs, st)
                u = leaf_u(pieces, factored, beta)
                u_rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
                u.div_(torch.clamp(u_rms, min=1.0))
                # p - (lr u + lr wd p), elementwise in slices of SLICE_ELEMS
                # elements, u's in place
                _, cuts = _slices((u[0].numel(),), False)
                wd_t = lr_t * weight_decay
                for i, (p, _, _) in enumerate(pieces):
                    flat, ui = p.view(-1), u[i].view(-1)
                    for cut in cuts:
                        p32 = flat[cut].float()
                        step_ = ui[cut].mul_(lr_t).add_(p32 * wd_t)
                        flat[cut] = p32.sub_(step_)
                if leaf.stacked and len(leaf.shape) == 2:
                    for j, p in enumerate(leaf.tensors):
                        p.copy_(pieces[0][0][j])
        return {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init=init, update=update, name="adafactor")


def make_optimizer(name: str, lr=None, total_steps: int = 10_000, warmup: int = 200) -> Optimizer:
    sched = cosine_schedule(lr or (3e-4 if name == "adamw" else 1e-3), warmup, total_steps)
    if name == "adamw":
        return adamw(lr=sched)
    if name == "adafactor":
        return adafactor(lr=sched)
    raise ValueError(name)
