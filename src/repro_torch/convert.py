"""Carry state from the reference package into the port: a model's weights
(``params_from_reference``) and a replica-polish chain's search state
(``chain_state_from_reference``).

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

__all__ = ["chain_state_from_reference", "params_from_reference"]


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a torch tensor of the same dtype; bfloat16 arrays
    (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects) go through
    their uint16 bits, never through float32."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# the subtree of each ported family's param tree whose leaves carry a
# leading layer axis
_STACKED = {"dense": "blocks", "ssm": "mamba", "hybrid": "mamba"}


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
    per-layer subtree (leading layer axis: ``blocks`` for dense, ``mamba``
    for ssm and hybrid) is unstacked into ``<subtree>.<i>.<path>``
    (``blocks.3.attn.wq``, ``mamba.3.in_proj``); the rest keeps the tree's
    path, joined with dots.  Load it with ``model.init(...).load_state_dict(sd)``
    (the family must be ported: dense, ssm or hybrid)."""
    if cfg.family not in _STACKED or cfg.moe is not None or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: model family {cfg.family!r} (moe={cfg.moe is not None}, "
            f"mrope={cfg.mrope}) is not ported yet; see ROADMAP.md, Queue 1")
    stacked = _STACKED[cfg.family]
    sd: dict[str, torch.Tensor] = {}
    for path, a in _flat("", params[stacked], {}).items():
        if a.shape[0] != cfg.n_layers:
            raise ValueError(f"{stacked}.{path} has {a.shape[0]} layers, expected {cfg.n_layers}")
        for i in range(cfg.n_layers):
            sd[f"{stacked}.{i}.{path}"] = _tensor(a[i])
    rest = _flat("", {k: v for k, v in params.items() if k != stacked}, {})
    sd.update((path, _tensor(a)) for path, a in rest.items())
    return sd


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
