"""Word-packed BFS sweep and min-plus insert patch: wrappers, plain versions
and packers (the counterpart of ``repro.kernels.bfs_sweep``).

The frontier (F) and visited (V) sets are packed 32 sources per ``uint32``
word along the *source* dimension, so one level advances every source at
once:

    N[v]  = OR_{u in nbr(v)} F[u] & vm[v]      (gather over the neighbour table)
    newF  = N & ~V;  V |= newF

and the delta pricing repairs a merged distance state with the min-plus
insert patch ``d'(r, y) = min(d(r, y), min_j tmp[r, j] + crows[j, y])``.

Two wrappers launch the hand-written CUDA kernels of
``csrc/bfs_sweep.cu``: ``sweep`` (``bfs_sweep_kernel``) and ``patch_apply``
(``minplus_patch_kernel``), each in the instantiation that its plan
(``sweep_plan``, ``patch_plan``) picks from the shape.  A CUDA tensor
launches the kernel or raises; a CPU tensor runs the plain PyTorch version
beside it (``sweep_rows_ref``, ``patch_apply_ref``), which is what the CPU
tests compare with the reference.  Each wrapper counts its launches in
``<wrapper>.launches`` and by shape in ``<wrapper>.shapes``.

The numpy packers are copies of the reference's, so both packages lay out
words, padding and idle lanes identically.  The plain versions hold words as
int32 (a ``.view`` of the uint32 packing): PyTorch's CPU backend has no
``~`` or ``>>`` for uint32, and every ``>>`` is masked with ``& 1`` because
int32 shifts sign-extend bit 31.
"""
from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from . import _build

WORD = 32  # uint32 packing, the reference's layout
BLOCK_WORDS = 4  # source words per reference grid cell (sets the padding)
# "unreachable" weight for masked patch entries: real hop distances are
# <= sentinel = n <= 46340, and the patch adds at most two PATCH_INF terms
# plus one distance (2^21 + n), so int32 arithmetic never overflows while
# masked terms can never undercut a real path
PATCH_INF = np.int32(1 << 20)
# shared memory one block can use on Hopper
SMEM_BYTES = 232448
# bfs_sweep_kernel keeps two frontier buffers (2 * n * 4 bytes) in one
# block's shared memory
MAX_SWEEP_N = SMEM_BYTES // 8

__all__ = [
    "WORD",
    "as_words",
    "BLOCK_WORDS",
    "PATCH_INF",
    "MAX_SWEEP_N",
    "PatchPlan",
    "SMEM_BYTES",
    "SweepPlan",
    "bfs_rows",
    "bfs_rows_batched",
    "pack_batch",
    "pack_delta_batch",
    "pack_frontier",
    "pack_nbr",
    "pack_patch",
    "patch_apply",
    "patch_apply_ref",
    "patch_plan",
    "patch_prologue",
    "sweep",
    "sweep_plan",
    "sweep_rows_ref",
]


# ------------------------------------------------------------------------------
# Packers (numpy copies of the reference's)
# ------------------------------------------------------------------------------

def pack_nbr(nbr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(gather table, validity word-mask) from a padded neighbour table.

    Pad entries (< 0) are redirected to vertex 0 and masked with an all-zero
    word so the in-kernel gather needs no bounds logic.
    """
    valid = nbr >= 0
    nb = np.where(valid, nbr, 0).astype(np.int32)
    vm = np.where(valid, np.uint32(0xFFFFFFFF), np.uint32(0))
    return nb, vm


def pack_frontier(n: int, sources: np.ndarray, sw_pad: int) -> np.ndarray:
    """(n, sw_pad) uint32 seed frontier: bit j of word w set at vertex
    ``sources[w * 32 + j]``."""
    F0 = np.zeros((n, sw_pad), dtype=np.uint32)
    m = len(sources)
    if m:
        j = np.arange(m)
        np.bitwise_or.at(F0, (np.asarray(sources, dtype=np.int64), j >> 5),
                         np.uint32(1) << (j & 31).astype(np.uint32))
    return F0


def pack_batch(
    nbrs: np.ndarray,
    sources: np.ndarray,
    block_words: int = BLOCK_WORDS,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Pack a (b, n, kmax) neighbour-table stack for the batched sweep:
    ``(nb, vm, F0, sw_pad, bw)`` with ``sw_pad`` a multiple of the block
    width ``bw`` and one shared source set broadcast to every graph."""
    b, n, kmax = nbrs.shape
    m = len(sources)
    sw = max(1, (m + WORD - 1) // WORD)
    bw = min(block_words, sw)
    sw_pad = -(-sw // bw) * bw
    nb = np.empty((b, n, kmax), dtype=np.int32)
    vm = np.empty((b, n, kmax), dtype=np.uint32)
    for r in range(b):
        nb[r], vm[r] = pack_nbr(nbrs[r])
    F0 = np.ascontiguousarray(np.broadcast_to(
        pack_frontier(n, sources, sw_pad), (b, n, sw_pad)))
    return nb, vm, F0, sw_pad, bw


def _pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1): pads variable per-iteration
    shapes (affected-row words, patch endpoints) into a bounded set."""
    return 1 << max(0, int(x) - 1).bit_length()


def pack_delta_batch(
    nbrs: np.ndarray,
    sources_list,
    n_rows: int,
    block_words: int = BLOCK_WORDS,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Pack per-proposal restricted frontiers for the batched delta sweep.

    Each of the b proposals sweeps its own affected-row set.  Returns
    ``(nb, vm, F0, ids, sw_pad, bw)``: ``ids[r, j]`` is the representative
    row swept by packed lane j of proposal r, padded with ``n_rows`` so the
    merge drops the idle lanes.  ``sw_pad`` is bucketed to a power of two.
    """
    b, n, kmax = nbrs.shape
    mx = max((len(src) for src in sources_list), default=0)
    sw = _pow2((mx + WORD - 1) // WORD)
    bw = min(block_words, sw)
    sw_pad = -(-sw // bw) * bw
    nb = np.empty((b, n, kmax), dtype=np.int32)
    vm = np.empty((b, n, kmax), dtype=np.uint32)
    F0 = np.empty((b, n, sw_pad), dtype=np.uint32)
    ids = np.full((b, sw_pad * WORD), n_rows, dtype=np.int32)
    for r in range(b):
        nb[r], vm[r] = pack_nbr(nbrs[r])
        src = np.asarray(sources_list[r], dtype=np.int64)
        F0[r] = pack_frontier(n, src, sw_pad)
        ids[r, : len(src)] = src
    return nb, vm, F0, ids, sw_pad, bw


def pack_patch(patches, s: int) -> tuple[np.ndarray, ...]:
    """Pack per-proposal min-plus insert patches for the delta sweep.

    ``patches[r]`` is the proposal's added edge list (empty/None for no
    patch).  Returns the seven padded arrays ``patch_prologue`` consumes:
    rolled-row gather metadata (``crow_src``, ``crow_shift``), the endpoint
    index set (``pts_idx``, ``pmask``) and the added-edge clamp
    (``add_i``, ``add_j``, ``add_w``).  Endpoint/edge counts are bucketed to
    powers of two; masked slots carry ``PATCH_INF`` weights.
    """
    b = len(patches)
    pts_all = [sorted({x for e in (p or ()) for x in e}) for p in patches]
    mmax = _pow2(max((len(p) for p in pts_all), default=0))
    amax = _pow2(max((len(p or ()) for p in patches), default=0))
    crow_src = np.zeros((b, mmax), dtype=np.int32)
    crow_shift = np.zeros((b, mmax), dtype=np.int32)
    pts_idx = np.zeros((b, mmax), dtype=np.int32)
    pmask = np.zeros((b, mmax), dtype=bool)
    add_i = np.zeros((b, amax), dtype=np.int32)
    add_j = np.zeros((b, amax), dtype=np.int32)
    add_w = np.full((b, amax), PATCH_INF, dtype=np.int32)
    for r, added in enumerate(patches):
        pts = pts_all[r]
        if not pts:
            continue
        idx = {p: i for i, p in enumerate(pts)}
        m = len(pts)
        crow_src[r, :m] = [p % s for p in pts]
        crow_shift[r, :m] = [p - p % s for p in pts]
        pts_idx[r, :m] = pts
        pmask[r, :m] = True
        for a, (u, v) in enumerate(added):
            add_i[r, a], add_j[r, a], add_w[r, a] = idx[u], idx[v], 1
    return crow_src, crow_shift, pts_idx, pmask, add_i, add_j, add_w


def _row_block(s: int, cap: int = 128) -> int:
    """Largest divisor of ``s`` at most ``cap`` — the reference patch
    kernel's row-tile height (kept for layout parity; the CUDA kernel cuts
    rows by its plan and masks the ragged edge)."""
    return max(d for d in range(1, min(s, cap) + 1) if s % d == 0)


def as_words(x: np.ndarray, device) -> torch.Tensor:
    """A packed numpy array on ``device`` as int32 (uint32 words are viewed,
    not converted, so every bit is kept)."""
    x = np.require(x, requirements="CW")  # torch wants a writable array
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x).to(device)


# ------------------------------------------------------------------------------
# Plain PyTorch versions
# ------------------------------------------------------------------------------

def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(b, n, w) int32 words -> (b, w*32, n) bool; bit j of word w = row
    w*32 + j."""
    b, n, w = words.shape
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1  # & 1: int32 >> sign-extends
    return bits.reshape(b, n, w * WORD).transpose(1, 2).bool()


def sweep_rows_ref(nb: torch.Tensor, vm: torch.Tensor, F0: torch.Tensor,
                   sentinel: int) -> torch.Tensor:
    """Plain packed sweep over a stack of graphs: (b, n, kmax) gather table,
    (b, n, kmax) int32 validity words and (b, n, sw) int32 seed frontier ->
    (b, sw*32, n) int32 hop distances, ``sentinel`` where unreachable."""
    b, _, kmax = nb.shape
    nb = nb.long()
    gidx = torch.arange(b, device=nb.device)[:, None]
    dist = torch.where(_unpack_bits(F0), 0, sentinel).to(torch.int32)
    F = V = F0
    d = 0
    while bool((F != 0).any()):
        d += 1
        N = torch.zeros_like(F)
        for j in range(kmax):
            N |= F[gidx, nb[:, :, j]] & vm[:, :, j : j + 1]
        F = N & ~V
        V = V | F
        dist = torch.where(_unpack_bits(F), d, dist)
    return dist


def patch_prologue(new, crow_src, crow_shift, pts_idx, pmask, add_i, add_j,
                   add_w):
    """Batched patch head: rolled endpoint rows + min-plus closure.

    ``new`` is the merged (b, s, n) post-removal state; the other arguments
    are ``pack_patch``'s arrays as tensors on ``new``'s device.  The full
    row of an endpoint p is ``roll(new[p % s], p - p % s)`` (the
    post-removal graph is still rotationally symmetric), built as the
    gather ``new[src, (y - shift) % n]``; a Floyd–Warshall closure over the
    masked endpoint set, with the added edges clamped to weight 1, gives the
    endpoint-to-endpoint distances.  Returns ``(tmp, crows)``:
    ``tmp[r, j] = min_p new[r, p] + w[p, j]`` (b, s, mmax) and the rolled
    rows (b, mmax, n).
    """
    b, s, n = new.shape
    mmax = pts_idx.shape[1]
    dev = new.device
    cols = (torch.arange(n, device=dev)[None, None, :]
            - crow_shift.long()[:, :, None]) % n
    crows = new[torch.arange(b, device=dev)[:, None, None],
                crow_src.long()[:, :, None], cols]
    inf = torch.tensor(int(PATCH_INF), dtype=torch.int32, device=dev)
    ok = pmask[:, :, None] & pmask[:, None, :]
    pts = pts_idx.long()
    w = torch.where(ok, torch.gather(crows, 2, pts[:, None, :].expand(b, mmax, mmax)),
                    inf)
    w = w.reshape(b, mmax * mmax)
    # .at[i, j].min with repeated and padded (0, 0) indices: a scatter-min
    for i, j in ((add_i, add_j), (add_j, add_i)):
        w = w.scatter_reduce(1, (i.long() * mmax + j.long()), add_w, "amin")
    w = w.reshape(b, mmax, mmax)
    for kk in range(mmax):
        w = torch.minimum(w, w[:, :, kk : kk + 1] + w[:, kk : kk + 1, :])
    a = torch.where(pmask[:, None, :],
                    torch.gather(new, 2, pts[:, None, :].expand(b, s, mmax)), inf)
    tmp = (a[:, :, :, None] + w[:, None, :, :]).amin(dim=2)
    return tmp, crows


def patch_apply_ref(dist, tmp, crows):
    """Plain batched min-plus patch:
    ``d'(r, y) = min(d(r, y), min_j tmp[r, j] + crows[j, y])`` over the
    (b, s, n) merged states."""
    for j in range(crows.shape[1]):
        dist = torch.minimum(dist, tmp[:, :, j : j + 1] + crows[:, j : j + 1, :])
    return dist


# ------------------------------------------------------------------------------
# Wrappers: the CUDA kernel on a CUDA tensor, the plain version on a CPU one
# ------------------------------------------------------------------------------

_WORD_DTYPES = (torch.int32, torch.uint32)
_SWEEP_THREADS = 1024
# the shared-memory table holds one 16-byte row of eight 16-bit byte offsets
# per vertex, and a thread keeps four level bit-planes of each of its
# vertices in registers, which fits 8 vertices a thread
_TABLE_KMAX = 8
_TABLE_VPT = 8


class SweepPlan(NamedTuple):
    """How ``bfs_sweep_kernel`` runs one shape.  ``graph`` is "shared" (the
    neighbour table read once per graph into shared memory as 16-bit
    offsets) or "global" (each vertex's rows read from device memory at
    every level); ``threads`` per block, ``vpt`` vertices per thread (a
    power of two), ``smem_bytes`` of dynamic shared memory per block."""

    graph: str
    threads: int
    vpt: int
    smem_bytes: int


def sweep_plan(n: int, kmax: int) -> SweepPlan:
    """The instantiation of ``bfs_sweep_kernel`` that a graph of ``n``
    vertices and ``kmax`` table columns runs: the shared-memory table where
    it fits (kmax <= 8 and n <= 8192), else rows from device memory.  Both
    keep two frontier buffers in shared memory, so n <= ``MAX_SWEEP_N``."""
    if not 1 <= n <= MAX_SWEEP_N:
        raise ValueError(
            f"bfs_sweep_kernel holds two frontier buffers in shared memory: n={n} "
            f"is outside 1..{MAX_SWEEP_N} (2 * n * 4 bytes must fit {SMEM_BYTES})")
    threads = min(_SWEEP_THREADS, -(-n // WORD) * WORD)
    vpt = _pow2(-(-n // threads))
    if kmax <= _TABLE_KMAX and vpt <= _TABLE_VPT:
        words = -(-(n + 1) // 4) * 4  # n frontier words and a zero word, 16-byte rows
        return SweepPlan("shared", threads, vpt, 2 * words * 4 + n * _TABLE_KMAX * 2)
    return SweepPlan("global", threads, vpt, 2 * n * 4)


def sweep(nb: torch.Tensor, vm: torch.Tensor, F0: torch.Tensor,
          sentinel: int) -> torch.Tensor:
    """Batched packed BFS sweep: (b, n, kmax) gather table, (b, n, kmax)
    validity words and (b, n, sw_pad) seed frontier (words as int32, or
    uint32) -> (b, sw_pad*32, n) int32 distances, ``sentinel`` where
    unreachable.  Launches ``bfs_sweep_kernel`` on a CUDA tensor (the
    instantiation ``sweep_plan`` picks; each launch also counts its
    (b, sw_pad) in ``sweep.shapes``); runs ``sweep_rows_ref`` on a CPU
    tensor."""
    if nb.dim() != 3 or F0.dim() != 3:
        raise ValueError(f"sweep takes (b, n, kmax) and (b, n, sw_pad) tensors, "
                         f"got {tuple(nb.shape)} and {tuple(F0.shape)}")
    b, n, kmax = nb.shape
    sw_pad = F0.shape[2]
    dev = nb.device
    _build.check_tensor("nb", nb, (b, n, kmax), (torch.int32,), dev)
    _build.check_tensor("vm", vm, (b, n, kmax), _WORD_DTYPES, dev)
    _build.check_tensor("F0", F0, (b, n, sw_pad), _WORD_DTYPES, dev)
    vm, F0 = vm.view(torch.int32), F0.view(torch.int32)
    if dev.type == "cpu":
        return sweep_rows_ref(nb, vm, F0, sentinel)
    if dev.type != "cuda":
        raise ValueError(f"sweep runs on a CUDA or CPU tensor, got {dev}")
    out = torch.empty((b, sw_pad * WORD, n), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    plan = sweep_plan(n, kmax)
    err = _build.library().bfs_sweep_launch(
        nb.data_ptr(), vm.data_ptr(), F0.data_ptr(), out.data_ptr(),
        b, n, kmax, sw_pad, int(sentinel), plan.graph == "shared", plan.threads,
        plan.vpt, plan.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(err, "bfs_sweep_kernel")
    sweep.launches += 1
    sweep.shapes[(b, sw_pad)] += 1
    return out


sweep.launches = 0
sweep.shapes = Counter()  # launches by (b, sw_pad)


# minplus_patch_kernel's stream instantiations: one per endpoint count that
# pack_patch makes (a power of two), crows kept in registers (4 * mmax)
_PATCH_TEMPLATES = (1, 2, 4, 8, 16, 32)
_PATCH_MAX_WARPS = 8  # consumer warps: a strip of up to 1024 columns
_PATCH_ROWS = 8  # rows per stage: one bulk copy each
_PATCH_RING_BYTES = 100 * 1024  # the stages of one block; two blocks an SM
# the tile instantiation: a 1024-thread block per 32 x 128 tile, tmp and
# crows staged 32 endpoints at a time in 20 KB of static shared memory
_TILE = (1024, 128, 32, (32 * 32 + 32 * 128) * 4)
_GRID_Y_Z = 65535


class PatchPlan(NamedTuple):
    """How ``minplus_patch_kernel`` runs one shape.  ``kind`` is "stream"
    (persistent blocks streaming dist through a ring of ``stages``
    shared-memory stages of ``rows`` row segments of a ``strip``-column
    strip, crows in registers; ``mmax`` the template's endpoint count) or
    "tile" (a block per ``rows`` x ``strip`` tile, any shape; ``mmax`` 0).
    ``threads`` per block (a stream block's last warp is its producer),
    ``smem_bytes`` of shared memory per block."""

    kind: str
    mmax: int
    threads: int
    strip: int
    rows: int
    stages: int
    smem_bytes: int


def _patch_smem(mmax: int, strip: int, rows: int, stages: int) -> int:
    """A stream block's shared memory: per stage its dist rows, its tmp rows
    where they come by bulk copy (mmax % 4 == 0), and two mbarriers."""
    tmp_bytes = rows * mmax * 4 if mmax % 4 == 0 else 0
    return stages * (rows * strip * 4 + tmp_bytes + 16)


def patch_plan(b: int, s: int, n: int, mmax: int, aligned: bool = True) -> PatchPlan:
    """The instantiation of ``minplus_patch_kernel`` for (b, s, n) states and
    ``mmax`` endpoints: "stream" for mmax in 1, 2, 4, ..., 32 with n % 4 == 0
    and 16-byte ``aligned`` tensors (its strip as wide as n needs, up to 1024
    columns; its ring of stages within 100 KB, so two blocks share an SM),
    else "tile", exact for any shape.  Raises for an empty or negative shape
    and for a tile grid beyond the card's limits."""
    if min(b, s, n) < 1 or mmax < 0:
        raise ValueError(f"minplus_patch_kernel takes b, s, n >= 1 and mmax >= 0, "
                         f"got b={b} s={s} n={n} mmax={mmax}")
    warps = min(_PATCH_MAX_WARPS, -(-n // (4 * WORD)))
    strip = 4 * WORD * warps
    if (mmax in _PATCH_TEMPLATES and n % 4 == 0 and aligned
            and b * -(-n // strip) * s < 2**31):  # (proposal, strip, row) units
        stage = _patch_smem(mmax, strip, _PATCH_ROWS, 1)
        stages = _PATCH_RING_BYTES // stage
        return PatchPlan("stream", mmax, WORD * (warps + 1), strip, _PATCH_ROWS, stages,
                         stages * stage)
    threads, strip, rows, smem = _TILE
    if b > _GRID_Y_Z or -(-s // rows) > _GRID_Y_Z:
        raise ValueError(f"minplus_patch_kernel's tile instantiation takes b <= {_GRID_Y_Z} "
                         f"and s <= {_GRID_Y_Z * rows}, got b={b} s={s}")
    return PatchPlan("tile", 0, threads, strip, rows, 0, smem)


def _launch_patch(dist, tmp, crows, out, plan: PatchPlan) -> None:
    """Enqueue ``minplus_patch_kernel`` in ``plan``'s instantiation."""
    b, s, n = dist.shape
    err = _build.library().minplus_patch_launch(
        dist.data_ptr(), tmp.data_ptr(), crows.data_ptr(), out.data_ptr(), b, s, n,
        crows.shape[1], plan.mmax, plan.threads, plan.strip, plan.rows, plan.stages,
        plan.smem_bytes, torch.cuda.current_stream(dist.device).cuda_stream)
    _build.raise_on_error(err, "minplus_patch_kernel")


def patch_apply(dist: torch.Tensor, tmp: torch.Tensor,
                crows: torch.Tensor) -> torch.Tensor:
    """Batched min-plus insert patch over (b, s, n) int32 states, with
    (b, s, mmax) ``tmp`` and (b, mmax, n) ``crows`` from ``patch_prologue``.
    Launches ``minplus_patch_kernel`` on a CUDA tensor (the instantiation
    ``patch_plan`` picks; each launch also counts its (b, mmax) in
    ``patch_apply.shapes``); runs ``patch_apply_ref`` on a CPU tensor.
    Returns a new tensor."""
    if dist.dim() != 3 or crows.dim() != 3:
        raise ValueError(f"patch_apply takes (b, s, n) and (b, mmax, n) tensors, "
                         f"got {tuple(dist.shape)} and {tuple(crows.shape)}")
    b, s, n = dist.shape
    mmax = crows.shape[1]
    dev = dist.device
    _build.check_tensor("dist", dist, (b, s, n), (torch.int32,), dev)
    _build.check_tensor("tmp", tmp, (b, s, mmax), (torch.int32,), dev)
    _build.check_tensor("crows", crows, (b, mmax, n), (torch.int32,), dev)
    if dev.type == "cpu":
        return patch_apply_ref(dist, tmp, crows)
    if dev.type != "cuda":
        raise ValueError(f"patch_apply runs on a CUDA or CPU tensor, got {dev}")
    out = torch.empty_like(dist)
    if out.numel() == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (dist, tmp, crows, out))
    _launch_patch(dist, tmp, crows, out, patch_plan(b, s, n, mmax, aligned))
    patch_apply.launches += 1
    patch_apply.shapes[(b, mmax)] += 1
    return out


patch_apply.launches = 0
patch_apply.shapes = Counter()  # launches by (b, mmax)


# ------------------------------------------------------------------------------
# BFS rows
# ------------------------------------------------------------------------------

def bfs_rows_batched(
    nbrs: np.ndarray,
    sources: np.ndarray,
    sentinel: int,
    device=None,
    block_words: int = BLOCK_WORDS,
) -> torch.Tensor:
    """Batched BFS: (b, n, kmax) neighbour tables -> (b, m, n) int32 tensor
    on ``device``; every graph shares the same ``sources``."""
    dev = resolve_device(device)
    m = len(sources)
    nb, vm, F0, _, _ = pack_batch(nbrs, sources, block_words)
    out = sweep(as_words(nb, dev), as_words(vm, dev), as_words(F0, dev), sentinel)
    return out[:, :m, :]


def bfs_rows(
    nbr: np.ndarray,
    sources: np.ndarray,
    sentinel: int,
    device=None,
    block_words: int = BLOCK_WORDS,
) -> np.ndarray:
    """Hop distances from ``sources`` as a (len(sources), n) int32 numpy
    array — the counterpart of ``repro.kernels.bfs_sweep.bfs_rows`` and of
    the host ``bitset_bfs_rows`` (sentinel included; any source count)."""
    dev = resolve_device(device)
    m = len(sources)
    n = nbr.shape[0]
    if m == 0:
        return np.full((0, n), sentinel, dtype=np.int32)
    out = bfs_rows_batched(nbr[None], np.asarray(sources), sentinel,
                           device=dev, block_words=block_words)
    return out[0].cpu().numpy()
