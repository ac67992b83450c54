"""Topology-derived collective schedules executed with ``torch.distributed``
(the counterpart of ``repro.comm.jaxcoll``).

The simulator (``core.collectives``) *predicts* schedule cost on a graph;
this module *runs* the same schedules with point-to-point transfers.  The
bridge to the paper: the rank order of a ring schedule is a Hamiltonian
cycle of the physical graph (``core.hamiltonian``), and the mesh device
order comes from the MPL/QAP layout (``core.layout``) — so every permute
step below is a 1-hop transfer on the optimized topology.

Every function runs on each rank of a process group (``group``; ``None`` is
the world group) and takes that rank's tensor, where the reference runs
inside ``shard_map`` and takes ``axis_name``.  One private ``_ppermute``
over ``dist.batch_isend_irecv`` stands for ``lax.ppermute``: a rank that is
no pair's destination receives zeros.  Tensors stay where the caller put
them: a gloo group takes CPU tensors and an NCCL group CUDA tensors; a
tensor on the other kind of device raises ``ValueError`` and is never
moved.

  ring_reduce_scatter / ring_allgather / ring_allreduce
      bandwidth-optimal ring schedules (2(n-1)/n · bytes on the wire)
  recursive_doubling_allreduce
      latency-optimal for small payloads (log n rounds)
  flood_bcast
      BFS flooding along *actual graph edges* (eccentricity rounds, all
      transfers 1 hop) — the topology-aware broadcast from core.collectives
  int8_ring_allreduce
      per-chunk absmax int8 quantization around the same ring schedule —
      ~4x fewer wire bytes, quantization error bounded by tests

``run_on_axis`` replaces the reference's ``shard_map`` harness: it spawns one
process per rank, joins them in a group through a ``file://`` store in a
temporary directory (no network port), hands each rank its slice of the
arguments and stacks the ranks' outputs.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core import collectives as C
from ..core.graphs import Graph

__all__ = [
    "ring_perm",
    "ring_reduce_scatter",
    "ring_allgather",
    "ring_allreduce",
    "recursive_doubling_allreduce",
    "int8_ring_allreduce",
    "flood_bcast",
    "run_on_axis",
]


def ring_perm(n: int, order: Sequence[int] | None = None, reverse: bool = False):
    """Permute pairs for one ring step over a device order (Hamiltonian)."""
    order = list(order) if order is not None else list(range(n))
    pairs = []
    for i in range(n):
        src = order[i]
        dst = order[(i + 1) % n]
        pairs.append((dst, src) if reverse else (src, dst))
    return pairs


def _check_backend(backend: str, device: torch.device) -> None:
    """gloo's point-to-point moves host memory and NCCL's device memory; a
    tensor on the other kind of device is refused, never moved (on a CUDA
    tensor gloo's TCP transport fails inside ``writev``)."""
    want = {"gloo": "cpu", "nccl": "cuda"}.get(str(backend))
    if want is not None and device.type != want:
        raise ValueError(f"a {backend} group takes {want} tensors, got one on {device}: "
                         f"move it there first")


def _axis(group, x: torch.Tensor) -> tuple[int, int]:
    """(size, my rank) of ``group``, after checking that its backend takes
    ``x``'s device."""
    _check_backend(dist.get_backend(group), x.device)
    return dist.get_world_size(group), dist.get_rank(group)


def _ppermute(x: torch.Tensor, perm, group=None) -> torch.Tensor:
    """``lax.ppermute``: each (src, dst) pair of ``perm`` (group ranks, each
    source and each destination at most once) sends src's ``x`` to dst;
    a rank that is no pair's destination receives zeros."""
    _, rank = _axis(group, x)
    peer = (lambda r: r) if group is None else (lambda r: dist.get_global_rank(group, r))
    ops = []
    out = torch.zeros_like(x)
    for src, dst in perm:
        if src == rank:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), peer(dst), group))
        if dst == rank:
            ops.append(dist.P2POp(dist.irecv, out, peer(src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _my_ring_index(rank: int, order: Sequence[int] | None) -> int:
    if order is None:
        return rank
    inv = np.argsort(np.asarray(order))  # physical rank -> ring position
    return int(inv[rank])


def ring_reduce_scatter(x: torch.Tensor, group=None,
                        order: Sequence[int] | None = None) -> torch.Tensor:
    """Per-rank input x (same shape everywhere) -> my 1/n reduced chunk.

    x's leading dim must be divisible by n.  Returns chunk of shape
    (x.shape[0] // n, ...), the fully-reduced chunk this rank owns.
    """
    n, rank = _axis(group, x)
    assert x.shape[0] % n == 0
    chunks = x.reshape(n, x.shape[0] // n, *x.shape[1:])
    pos = _my_ring_index(rank, order)
    perm = ring_perm(n, order)

    # start by forwarding my partial of chunk (pos-1); at step s the incoming
    # partial is for chunk (pos-s-2), to which I add my contribution; after
    # n-1 steps I hold the fully reduced chunk `pos`
    acc = chunks[(pos - 1) % n]
    for s in range(n - 1):
        recv = _ppermute(acc, perm, group)
        acc = recv + chunks[(pos - s - 2) % n]
    return acc.clone() if n == 1 else acc  # fully reduced chunk `pos`


def ring_allgather(x: torch.Tensor, group=None,
                   order: Sequence[int] | None = None) -> torch.Tensor:
    """Per-rank chunk -> concatenation of all chunks (ring, n-1 steps)."""
    n, rank = _axis(group, x)
    pos = _my_ring_index(rank, order)
    perm = ring_perm(n, order)
    out = torch.zeros((n, *x.shape), dtype=x.dtype, device=x.device)
    cur = x
    idx = pos
    out[idx] = cur
    for _ in range(n - 1):
        cur = _ppermute(cur, perm, group)
        idx = (idx - 1) % n
        out[idx] = cur
    return out.reshape(n * x.shape[0], *x.shape[1:])


def ring_allreduce(x: torch.Tensor, group=None,
                   order: Sequence[int] | None = None) -> torch.Tensor:
    """Bandwidth-optimal ring allreduce; x identical-shaped on all ranks."""
    n, _ = _axis(group, x)
    lead = x.shape[0] if x.ndim else 1
    pad = (-lead) % n
    if x.ndim:
        xp = torch.nn.functional.pad(x.reshape(lead, -1), (0, 0, 0, pad))
    else:
        xp = x.reshape(1, 1)
    chunk = ring_reduce_scatter(xp, group, order)
    full = ring_allgather(chunk, group, order)
    full = full[:lead] if pad else full
    return full.reshape(x.shape)


def recursive_doubling_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """log2(n) rounds of XOR-partner exchange (latency-optimal, small msgs)."""
    n, _ = _axis(group, x)
    assert n & (n - 1) == 0, "recursive doubling needs power-of-two axis"
    x = x.clone()
    mask = 1
    while mask < n:
        perm = [(i, i ^ mask) for i in range(n)]
        x = x + _ppermute(x, perm, group)
        mask <<= 1
    return x


def _q(v: torch.Tensor):
    scale = torch.clamp(v.abs().max(), min=1e-12) / 127.0
    return torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8), scale.reshape(1)


def _dq(qv: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return qv.to(torch.float32) * scale[0]


def int8_ring_allreduce(x: torch.Tensor, group=None,
                        order: Sequence[int] | None = None) -> torch.Tensor:
    """Ring allreduce with int8-quantized payloads (per-hop requantization).

    Wire bytes ~ x.nbytes/4 + scales (each a one-element float32 tensor).
    Quantization error per hop is bounded by scale/254; after n-1 hops
    relative error stays ~1e-2 for n<=32 (tested).  ``torch.round`` rounds
    half to even, as ``jnp.round`` does.
    """
    n, rank = _axis(group, x)
    lead = x.shape[0]
    pad = (-lead) % n
    xp = torch.nn.functional.pad(x.reshape(lead, -1).to(torch.float32), (0, 0, 0, pad))
    chunks = xp.reshape(n, xp.shape[0] // n, -1)
    pos = _my_ring_index(rank, order)
    perm = ring_perm(n, order)

    acc = chunks[(pos - 1) % n]
    for s in range(n - 1):
        qv, scale = _q(acc)
        qv_r = _ppermute(qv, perm, group)
        scale_r = _ppermute(scale, perm, group)
        acc = _dq(qv_r, scale_r) + chunks[(pos - s - 2) % n]
    # allgather phase, also int8
    qv, scale = _q(acc)
    out = torch.zeros((n, *acc.shape), dtype=torch.float32, device=x.device)
    idx = pos
    out[idx] = acc
    cur_q, cur_s = qv, scale
    for _ in range(n - 1):
        cur_q = _ppermute(cur_q, perm, group)
        cur_s = _ppermute(cur_s, perm, group)
        idx = (idx - 1) % n
        out[idx] = _dq(cur_q, cur_s)
    flat = out.reshape(xp.shape[0], -1)
    flat = flat[:lead] if pad else flat
    return flat.reshape(x.shape).to(x.dtype)


def flood_bcast(x: torch.Tensor, group=None, g: Graph | None = None,
                root: int = 0) -> torch.Tensor:
    """BFS-flood broadcast along graph edges (all transfers 1 hop).

    Ranks other than root contribute zeros; after ecc(root) rounds every
    rank holds root's value.  Rounds come from core.collectives.bcast_flood.
    """
    n, rank = _axis(group, x)
    assert g is not None and g.n == n
    sched = C.bcast_flood(n, 0.0, g, root=root)
    have = rank == root
    val = x.clone() if have else torch.zeros_like(x)
    for rnd in sched.rounds:
        # a permute needs unique sources; a node feeding several neighbours in
        # one simulator round (one port per neighbour on real hardware) is
        # decomposed into sub-permutes by per-source ordinal.
        by_src: dict[int, list[int]] = {}
        subrounds: list[list[tuple[int, int]]] = []
        for t in rnd:
            k = len(by_src.setdefault(t.src, []))
            by_src[t.src].append(t.dst)
            while len(subrounds) <= k:
                subrounds.append([])
            subrounds[k].append((t.src, t.dst))
        for perm in subrounds:
            recv = _ppermute(val, perm, group)
            is_dst = any(d == rank for _, d in perm)
            if is_dst and not have:
                val = recv
            have = have or is_dst
    return val


# ------------------------------------------------------------------------------
# process-group harness for tests and examples
# ------------------------------------------------------------------------------

# run_on_axis stops every rank of a group still running after this long
RUN_TIMEOUT_S = 600.0


def _rank_main(rank: int, fn, n: int, backend: str, store: str, outdir: str, args) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dev = torch.device("cuda", rank) if backend == "nccl" else None
    if dev is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=n, rank=rank,
                            device_id=dev)
    try:
        xs = [torch.as_tensor(np.asarray(a[rank])) for a in args]
        if dev is not None:
            xs = [x.to(dev) for x in xs]
        out = fn(*xs, group=dist.group.WORLD)
        outs = out if isinstance(out, tuple) else (out,)
        torch.save(tuple(o.cpu() for o in outs), os.path.join(outdir, f"out{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_on_axis(fn, n: int, *args, backend: str = "gloo"):
    """Test/demo harness: ``args`` have leading dim ``n`` (per-rank inputs,
    numpy arrays or tensors); ``fn(*slices, group=...)`` runs on each of
    ``n`` spawned ranks (``backend`` "gloo": CPU tensors; "nccl": each rank
    on CUDA device ``rank``) and the ranks' outputs come back stacked along a
    new leading axis as CPU tensors (so an allreduce returns n identical
    rows).  ``fn`` may return a tuple of tensors; each is stacked.  ``fn``
    and ``args`` are pickled into the ranks, so ``fn`` is a module-level
    function (or a ``functools.partial`` of one).  Every rank is stopped
    when one fails or after ``RUN_TIMEOUT_S`` seconds."""
    import torch.multiprocessing as mp

    for a in args:
        if len(a) != n:
            raise ValueError(f"every argument needs leading dim {n}, got {len(a)}")
    with tempfile.TemporaryDirectory(prefix="torchcoll-") as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(_rank_main, args=(fn, n, backend, store, tmp, args),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + RUN_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_on_axis: {n} ranks still running after "
                                       f"{RUN_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        outs = [torch.load(os.path.join(tmp, f"out{r}.pt")) for r in range(n)]
    stacked = tuple(torch.stack([o[i] for o in outs]) for i in range(len(outs[0])))
    return stacked if len(stacked) > 1 else stacked[0]
