"""Carry search state from the reference package into the port.

Here the "weights" are search state: a replica-polish chain is its padded
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

__all__ = ["chain_state_from_reference"]


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
