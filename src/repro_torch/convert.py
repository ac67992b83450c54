"""Carry state between the reference package and the port: a model's
weights (``params_from_reference``, and back with ``params_to_reference``),
the reference tree's leaves over the port's parameters
(``reference_leaves``, what the optimizers and checkpoints walk) and a
replica-polish chain's search state (``chain_state_from_reference``).

For the search, the "weights" are search state: a replica-polish chain is its padded
neighbour table, its (s, n) int32 representative-row distances and its
orbit list.  ``chain_state_from_reference`` turns the reference's numpy
state into a port ``_PolishChain`` whose rows live on ``device``, so both
packages can be started from, or checked against, the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.search import _PolishChain
from .device import resolve_device
from .optim.optimizers import Leaf, tree_set

__all__ = ["chain_state_from_reference", "params_from_reference", "params_to_reference",
           "reference_leaves"]


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a torch tensor of the same dtype; bfloat16 arrays
    (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects) go through
    their uint16 bits, never through float32."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# the subtrees of each family's param tree whose leaves carry a leading
# layer axis, each with the config field that counts its layers
_STACKED = {
    "dense": {"blocks": "n_layers"},
    "moe": {"blocks": "n_layers"},
    "vlm": {"blocks": "n_layers"},
    "ssm": {"mamba": "n_layers"},
    "hybrid": {"mamba": "n_layers"},
    "encdec": {"enc_blocks": "enc_layers", "dec_blocks": "n_layers"},
}


def _flat(prefix: str, tree, out: dict) -> dict:
    """The leaves of a nested dict, keyed by their dotted paths."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _flat(f"{prefix}.{key}" if prefix else key, sub, out)
    else:
        out[prefix] = tree
    return out


def params_from_reference(cfg, params: dict) -> dict:
    """The port's state dict for the reference's param tree, given as numpy
    arrays (``jax.tree.map(np.asarray, params)``).  The family's stacked
    per-layer subtrees (leading layer axis: ``blocks`` for dense, moe and
    vlm, ``mamba`` for ssm and hybrid, ``enc_blocks`` and ``dec_blocks``
    for encdec, each checked against its own layer count) are unstacked
    into ``<subtree>.<i>.<path>`` (``blocks.3.attn.wq``,
    ``blocks.3.moe.shared.w1``, ``enc_blocks.1.mlp.w2``); the rest keeps
    the tree's path, joined with dots.  Load it with
    ``model.init(...).load_state_dict(sd)``."""
    if cfg.family not in _STACKED:
        raise ValueError(f"{cfg.name}: unknown model family {cfg.family!r}")
    stacks = _STACKED[cfg.family]
    sd: dict[str, torch.Tensor] = {}
    for stacked, field in stacks.items():
        n = getattr(cfg, field)
        for path, a in _flat("", params[stacked], {}).items():
            if a.shape[0] != n:
                raise ValueError(f"{stacked}.{path} has {a.shape[0]} layers, expected "
                                 f"{field}={n}")
            for i in range(n):
                sd[f"{stacked}.{i}.{path}"] = _tensor(a[i])
    rest = _flat("", {k: v for k, v in params.items() if k not in stacks}, {})
    sd.update((path, _tensor(a)) for path, a in rest.items())
    return sd


def _split(cfg, name: str) -> tuple[str, int | None]:
    """A port parameter name -> (its reference path joined with "/", its
    layer index or None): ``blocks.3.attn.wq`` -> ("blocks/attn/wq", 3)."""
    if cfg.family not in _STACKED:
        raise ValueError(f"{cfg.name}: unknown model family {cfg.family!r}")
    head, _, rest = name.partition(".")
    if head in _STACKED[cfg.family]:
        layer, _, rest = rest.partition(".")
        return f"{head}/{rest.replace('.', '/')}", int(layer)
    return name.replace(".", "/"), None


def reference_leaves(cfg, params) -> list[Leaf]:
    """The reference tree's leaves over the port's parameters (an
    ``nn.Module`` or a state dict), in the reference's flatten order
    (dict keys sorted at every level): each stacked subtree's leaf gathers
    its layers' tensors in layer order."""
    named = params.named_parameters() if hasattr(params, "named_parameters") else params.items()
    groups: dict[str, dict] = {}
    stacked: dict[str, bool] = {}
    for name, t in named:
        path, layer = _split(cfg, name)
        groups.setdefault(path, {})[layer] = t
        stacked[path] = layer is not None
    out = []
    for path in sorted(groups, key=lambda p: p.split("/")):
        layers = groups[path]
        tensors = tuple(layers[i] for i in sorted(layers)) if stacked[path] else (layers[None],)
        out.append(Leaf(path, tensors, stacked[path]))
    return out


def params_to_reference(cfg, params) -> dict:
    """The reference's param tree (nested dicts, each stacked subtree's
    leaves with their leading layer axis) of the port's parameters (an
    ``nn.Module`` or a state dict), as detached tensors on their device:
    the inverse of ``params_from_reference``."""
    tree: dict = {}
    for leaf in reference_leaves(cfg, params):
        ts = [t.detach() for t in leaf.tensors]
        tree_set(tree, leaf.path, torch.stack(ts) if leaf.stacked else ts[0])
    return tree


def chain_state_from_reference(nbr: np.ndarray, dist: np.ndarray, orb_list,
                               device=None) -> _PolishChain:
    """A port polish chain holding the reference's state.

    ``nbr`` is the reference chain's (n, kmax) padded neighbour table (pad
    -1), ``dist`` its (s, n) representative-row distances and ``orb_list``
    its chord orbits.  The chain's adjacency is rebuilt from ``nbr``; its
    rows are copied to ``device`` (``dist_t``) and kept on the host
    (``dist``); the best-state snapshot starts equal to the current state.
    The chain has no PRNG stream: it is for pricing and checking, not for
    drawing proposals.
    """
    dev = resolve_device(device)
    nbr = np.array(nbr, dtype=np.int32)
    n = nbr.shape[0]
    if dist.ndim != 2 or dist.shape[1] != n:
        raise ValueError(f"dist has shape {dist.shape}, expected (s, {n})")
    adj = np.zeros((n, n), dtype=bool)
    rows, cols = np.nonzero(nbr >= 0)
    adj[rows, nbr[rows, cols]] = True
    ch = _PolishChain(None, orb_list, adj, 0.0)
    ch.nbr = nbr
    ch.set_dist(torch.from_numpy(np.array(dist, dtype=np.int32)).to(dev))
    ch.best_dist, ch.best_dist_t = ch.dist, ch.dist_t
    return ch
