"""Sharding specs for whole train and serve states, from the logical axes
(the port's copy of ``repro.launch.specs``).

Shapes come from an init on the ``meta`` device (in place of
``jax.eval_shape``): no memory, no numbers.  Shardings are the model's
logical-axis trees through ``ShardingRules``, which drops any constraint
that does not divide, so the same specs serve a (1, 1, 1) mesh on one
card, the 8-rank test meshes and the 512-rank production mesh.  Every
tree here has the reference's shape: a stacked leaf (``blocks/attn/wq``)
has its layer axis first, and a ``NamedSharding`` whose spec starts with
None for it; ``place_params`` gives each of the port's per-layer tensors
its leaf's sharding without that entry (``NamedSharding.layer``).

Optimizer states inherit the parameters' shardings; Adafactor's factored
statistics drop the factored dim's entry (vr is a mean over the last dim,
vc over the one before).  Without a mesh every sharding is None and
``place`` leaves tensors as they are.
"""
from __future__ import annotations

from typing import Any

import torch

from ..convert import reference_leaves
from ..models.sharding import NamedSharding, make_rules
from ..models.zoo import Model, batch_logical_axes
from ..optim.optimizers import _factored_dims, tree_get, tree_set

__all__ = [
    "named", "param_shapes", "param_shardings", "opt_state_shardings", "batch_shardings",
    "cache_shardings", "train_state_specs", "serve_specs", "place", "place_params",
]


def named(model: Model, axes: tuple, dims: tuple[int, ...]) -> NamedSharding | None:
    return model.rules.sharding(*axes, dims=tuple(dims))


def _map(fn, tree, axes):
    """``fn(leaf, axes)`` over a tree and its matching axes tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, axes[k]) for k, v in tree.items()}
    return fn(tree, axes)


def _meta(model: Model) -> Model:
    return Model(cfg=model.cfg, device=torch.device("meta"), rules=make_rules(None))


def param_shapes(model: Model) -> dict:
    """The reference's param tree of ``meta`` tensors (shapes and dtypes)."""
    params = _meta(model).init(0)
    tree: dict = {}
    for leaf in reference_leaves(model.cfg, params):
        t = leaf.tensors[0]
        tree_set(tree, leaf.path, torch.empty(leaf.shape, dtype=t.dtype, device="meta"))
    return tree


def param_shardings(model: Model, shapes=None) -> dict:
    shapes = shapes if shapes is not None else param_shapes(model)
    return _map(lambda s, ax: named(model, tuple(ax), s.shape), shapes, model.param_axes())


def opt_state_shardings(model: Model, opt_name: str, pshapes=None) -> dict:
    pshapes = pshapes if pshapes is not None else param_shapes(model)
    paxes = model.param_axes()
    if opt_name == "adamw":
        t = _map(lambda s, ax: named(model, tuple(ax), s.shape), pshapes, paxes)
        return {"m": t, "v": t}
    if opt_name == "adafactor":
        def one(s, ax):
            ax, shp = tuple(ax), tuple(s.shape)
            fd = _factored_dims(shp)
            if fd is not None and min(shp[fd[0]], shp[fd[1]]) >= 16:
                r, c = fd
                return {"vr": named(model, ax[:c] + ax[c + 1:], shp[:c] + shp[c + 1:]),
                        "vc": named(model, ax[:r] + ax[r + 1:], shp[:r] + shp[r + 1:])}
            return {"v": named(model, ax, shp)}
        return {"stats": _map(one, pshapes, paxes)}
    raise ValueError(opt_name)


def batch_shardings(model: Model, specs: dict) -> dict:
    """Shardings of a batch's entries (anything with a ``shape``)."""
    return {k: named(model, batch_logical_axes(k, tuple(v.shape)), tuple(v.shape))
            for k, v in specs.items()}


def cache_shardings(model: Model, cache_shapes: dict) -> dict:
    axes = model.cache_axes()
    out = {}
    for k, v in cache_shapes.items():
        shape = tuple(getattr(v, "shape", ()))
        ax = tuple(axes.get(k) or ())
        if len(ax) != len(shape):
            ax = (None,) * len(shape)
        out[k] = named(model, ax, shape)
    return out


def _cache_shapes(model: Model, batch: int, max_seq: int) -> dict:
    """The cache's tensors as ``meta`` tensors (its int index as a 0-d
    int32, as the reference's)."""
    cache = _meta(model).init_cache(batch, max_seq)
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.empty((), dtype=torch.int32, device="meta"))
            for k, v in cache.items()}


# ------------------------------------------------------------------------------
# Whole-step spec bundles
# ------------------------------------------------------------------------------

def train_state_specs(model: Model, opt, opt_name: str) -> tuple[dict, dict]:
    """(state shapes, state shardings) for {'params', 'opt_state', 'step'}."""
    meta = _meta(model)
    pshapes = param_shapes(model)
    oshapes = opt.init(reference_leaves(model.cfg, meta.init(0)))
    shapes = {"params": pshapes, "opt_state": oshapes,
              "step": torch.empty((), dtype=torch.int32, device="meta")}
    shard = {"params": param_shardings(model, pshapes),
             "opt_state": opt_state_shardings(model, opt_name, pshapes),
             "step": named(model, (), ())}
    return shapes, shard


def serve_specs(model: Model, shape: Any) -> tuple[tuple, tuple]:
    """Shapes and shardings for decode: (params, tokens, cache).  ``shape``
    has ``global_batch`` and ``seq_len``."""
    pshapes = param_shapes(model)
    cache_shapes = _cache_shapes(model, shape.global_batch, shape.seq_len)
    tok = torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")
    return ((pshapes, tok, cache_shapes),
            (param_shardings(model, pshapes), named(model, ("batch", None), tuple(tok.shape)),
             cache_shardings(model, cache_shapes)))


# ------------------------------------------------------------------------------
# Placing tensors
# ------------------------------------------------------------------------------

def _place_one(t, sharding: NamedSharding | None):
    """A full tensor (the same on every rank) as a DTensor holding this
    rank's shard, on the mesh's device; split without communication."""
    if sharding is None or not isinstance(t, torch.Tensor):
        return t
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t.redistribute(sharding.mesh, sharding.placements)
    dev = torch.device(sharding.mesh.device_type) if sharding.mesh.device_type == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    return distribute_tensor(t.to(dev), sharding.mesh, sharding.placements, src_data_rank=None)


def place(tree, shardings):
    """A tree of tensors (nested dicts) placed onto a matching tree of
    shardings; a None sharding leaves its leaf as it is."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k] if shardings is not None else None)
                for k, v in tree.items()}
    return _place_one(tree, shardings)


def place_params(model: Model, params: torch.nn.Module, shardings: dict | None = None
                 ) -> torch.nn.Module:
    """Each of the module's parameters replaced, in place, by a DTensor
    parameter holding this rank's shard of it (a stacked leaf's sharding
    without its layer entry for each layer's tensor).  Returns the
    module."""
    shardings = shardings if shardings is not None else param_shardings(model)
    if model.mesh is None:
        return params
    owners = {}
    for name, _ in params.named_parameters():
        mod_name, _, attr = name.rpartition(".")
        owners[name] = (params.get_submodule(mod_name) if mod_name else params, attr)
    by_tensor = {id(t): name for name, t in params.named_parameters()}
    for leaf in reference_leaves(model.cfg, params):
        sh = tree_get(shardings, leaf.path)
        if leaf.stacked:
            sh = sh.layer()
        for t in leaf.tensors:
            mod, attr = owners[by_tensor[id(t)]]
            placed = _place_one(t.detach(), sh)
            setattr(mod, attr, torch.nn.Parameter(placed, requires_grad=t.requires_grad))
    return params
