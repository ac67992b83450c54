"""``engine="torch"`` — the batched circulant pricer (the counterpart of
``repro.core.engines.jax_circulant``, registry name "jax" there).

``circulant_search`` prices candidate offset sets; this module is the same
frontier sweep as the sequential ``search._circulant_profile``, batched over
candidate offset sets on a device: each candidate's frontier is one row of a
(chunk, n) bool tensor, and every level advances all candidates at once
(a vertex joins the frontier when a shift of it by some offset is in the
previous frontier).  Exact integer hop counts, so the values — and therefore
the hillclimb trajectory — are identical to the numpy pricer's.
"""
from __future__ import annotations

from collections.abc import Iterable

import numpy as np
import torch

__all__ = ["CHUNK", "profile_batch"]

CHUNK = 32  # candidates per sweep (padded, so every sweep has one shape)


def _sweep(shifts: torch.Tensor, n: int) -> tuple[torch.Tensor, ...]:
    """Batched frontier sweep for (chunk, m) shift tensors on C_n.

    Returns (total hops int64, diameter int64, connected bool) per candidate
    row.  Shift lists may contain duplicates (padding): OR-ing a frontier
    with itself is a no-op, so the counts stay exact.
    """
    b, m = shifts.shape
    dev = shifts.device
    # frontier[(v - shift) % n] reaches v: np.roll(frontier, shift)
    idx = ((torch.arange(n, device=dev)[None, None, :] - shifts[:, :, None]) % n).reshape(b, m * n)
    reach = torch.zeros((b, n), dtype=torch.bool, device=dev)
    reach[:, 0] = True
    frontier = reach.clone()
    total = torch.zeros(b, dtype=torch.int64, device=dev)
    diam = torch.zeros(b, dtype=torch.int64, device=dev)
    d = 0
    while bool(frontier.any()):
        nxt = frontier.gather(1, idx).view(b, m, n).any(1)
        frontier = nxt & ~reach
        cnt = frontier.sum(1)
        d += 1
        total += d * cnt
        diam = torch.where(cnt > 0, d, diam)
        reach |= frontier
    return total, diam, reach.all(1)


def profile_batch(n: int, offset_lists, device) -> Iterable[tuple[float, float]]:
    """(MPL, diameter) for a batch of full offset lists, lazily: the batch is
    packed into padded ``CHUNK``-row chunks (shift lists padded cyclically to
    the longest), and each chunk is priced in one sweep on ``device`` only
    when the caller reaches it, so a caller that stops consuming after an
    acceptance never pays for the unexamined chunks."""
    if not offset_lists:
        return iter(())
    shifts = []
    for offs in offset_lists:
        ss = sorted({s % n for s in offs} - {0})
        shifts.append(sorted({sh for s in ss for sh in (s, n - s)}))
    m = max(len(s) for s in shifts)
    arr = np.empty((len(shifts), m), dtype=np.int64)
    for i, s in enumerate(shifts):
        arr[i] = np.resize(s, m)  # cyclic pad: duplicate shifts are no-ops

    def chunks():
        for lo in range(0, len(shifts), CHUNK):
            chunk = arr[lo : lo + CHUNK]
            real = len(chunk)
            if real < CHUNK:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[:1], CHUNK - real, axis=0)])
            total, diam, conn = (x.cpu().numpy() for x in
                                 _sweep(torch.from_numpy(chunk).to(device), n))
            for i in range(real):
                if conn[i]:
                    yield (int(total[i]) / (n - 1), float(diam[i]))
                else:
                    yield (float("inf"), float("inf"))

    return chunks()
