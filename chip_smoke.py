#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the device: ``nvidia-smi`` name and power limit, PyTorch's device name;
2. build the CUDA kernels with nvcc (timed): ptxas's registers and spills,
   and the min and add-min opcodes of ``minplus_patch_kernel``'s
   instantiations in ``cuobjdump -sass``;
3. ``bfs_sweep_kernel`` against its plain PyTorch version, bit for bit, at
   the shapes the polish launches, from (8192, 8) graphs it prices (the
   pinned circulant and orbit swaps of it): the full re-sweep (b=32, all
   2048 representative rows, sw_pad=64), the kernel's row, and a delta
   batch (b=32, 0-47 affected rows each); then the first two rows this
   script timed (four (8192, <=8) graphs from 2048 sources, one
   disconnected; a delta batch of degree-8, 6 and 4 circulants), and the
   symmetric polish's b=1 shapes (24, 48 and 500 affected rows of a
   post-removal graph, sw_pad 1, 2 and 16; a full rebuild, sw_pad 64), all
   timed with their bounds; then small batches that reach every branch of
   the kernel (checked, not timed), each with the instantiation
   ``sweep_plan`` gave it;
4. ``minplus_patch_kernel`` against its plain version, bit for bit: timed
   at the polish's shape (b=32, s=2048, n=8192, mmax=16), at the first
   row's mmax=8, and at the symmetric polish's b=1, mmax=16, each beside
   the tile instantiation at the same shape, the plain version and (at
   b=32, mmax=16) ``out.copy_(dist)`` of the same state;
   on real priced (8192, 8) states (post-removal rows of orbit swaps,
   patched through ``patch_prologue``, must equal the swapped graphs' rows);
   then edge cases (mmax 1-64, n % 4 != 0, strips cut short, ragged runs,
   the largest sums, unaligned tensors; checked, not timed), each with the
   instantiation ``patch_plan`` gave it;
5. the main path, ``large_search(8192, 8, replicas=8, proposal_batch=4,
   polish_iters=32)`` on the card, with both kernels' launches counted (the
   sweep's also by (b, sw_pad), the patch's by (b, mmax)) and the result
   rechecked; then a short delta=False run, which must follow the same
   trajectory as delta=True over the same iterations;
6. the same search at (2048, 6) on the card and on the CPU (the kernels'
   plain versions): every field must be equal;
7. the default large-N call, ``large_search(8192, 8, seed=0, fold=4,
   polish_iters=200)`` with replicas=1: ``symmetric_sa_search`` priced by
   ``SymmetricAPSP`` on the card, with its time in ``evaluate_swap`` and
   ``commit``, its host<->device bytes, both kernels' launches by shape,
   peak memory and a 20-iteration profile; the result rechecked;
8. the reference benchmark's pinned ``symmetric_sa_search(8192, 8,
   n_iter=6, fold=8)`` on the card, rechecked;
9. replicas=1 on the card and on the CPU, every field equal: the default
   call at (2048, 6), the compound-move case at (64, 6), a compound
   proposal at (2048, 6) whose patch takes the tile instantiation (mmax
   64), and a disconnecting orbit swap and its recovery on
   ``SymmetricAPSP``;
10. the batched circulant pricer: ``circulant_search(8192, 8, seed=1,
    n_iter=400)`` with ``engine="torch"`` on the card and
    ``engine="numpy"``, the same trajectory, both timed; then
    ``large_search(8192, 8, seed=1)`` end to end (the hillclimb runs),
    rechecked;
11. the wgmma fragment layouts of ``flash_attention_kernel`` (bf16), then
    the kernel and ``flash_attention_fp32_kernel`` against their plain
    version at the serving shapes (zamba2: b=4, h=kv=32, s=1024, hd=80;
    qwen3-32b: b=4, h=64, kv=8, s=1024, hd=128; bf16, causal), at a GQA,
    ``q_offset`` and ragged case (h=32, kv=8, sq=200, skv=328) in bf16 and
    fp32, at head dims 16, 64, 112 and 128 in both dtypes, non-causal, on a
    ragged 19-row tile, with keys ending inside a tile, and at hd 128 with
    GQA 64/8 in fp32; both serving shapes timed, with
    ``scaled_dot_product_attention`` beside the kernel as a yardstick;
12. the wgmma fragment layouts of ``ssd_intra_chunk_kernel`` (bf16), then
    the kernel and ``ssd_intra_chunk_fp32_kernel`` against their plain
    version at the serving shapes (b*h=320, s=1024, p=64, chunk 256, bf16
    x/B/C; n=64 for zamba2, n=128 for mamba2-2.7b: one stage of shared
    memory) and at eight smaller shapes (p 8..128, n 16..128, chunks
    8..512; bf16 down to the domain's edge, chunk 64 and p = n = 16), and
    a bf16 chunk outside the domain refused; both serving shapes timed;
13. the serving path: ``ServingEngine`` on zamba2-2.7b at full width and
    full depth (54 Mamba2 layers, 9 applications of the shared attention
    block), bf16, seeded weights, 4 slots, 8 requests of 1024-token prompts
    in 2 waves, 32 greedy tokens each; both model kernels' launches counted
    (9 and 54 per prefill), TTFT, decode latency, throughput, peak memory
    (checked against the weights and caches), and a ``torch.profiler``
    readout of one prefill, with each hand-written kernel's device time and
    launches;
14. zamba2-2.7b at full width, depth 6 (one stage), float32, on the card
    and on the CPU: prefill and decode logits within a stated tolerance and
    the same greedy tokens;
15. phase 13 for qwen3-32b (dense; the reference launcher's default) at
    full width and depth (64 layers, 65.5 GB of bf16 weights, after the
    earlier phases' memory is freed): 64 attention launches per prefill;
16. phase 14 for qwen3-32b at depth 2;
17. phase 13 for mamba2-2.7b (ssm) at full width and depth: 64 SSD
    launches per prefill;
18. phase 14 for mamba2-2.7b at depth 4;
19. Table 1 and Algorithm 1: the paper's 14 named topologies at N <= 36
    (the integers of ``tests/test_golden.py``) through ``metrics.apsp`` on
    the card (every source in one ``bfs_sweep_kernel`` launch), held equal
    to its plain version, to the pinned total hops and diameter, to
    ``bisection_width`` and to ``certify``; ``exhaustive_search(12, 3)``;
    ``sa_search(16, 4)`` and ``sa_search(32, 4)`` (seed 0, 4000 iterations,
    4 replicas; host seconds), which must reach the paper's MPL (<= 1.75 and
    <= 2.36) and equal the reference's (1.75 and 2.3548387...), their graphs
    rechecked on the card;
20. ``metrics.apsp_hops`` of phase 7's (8192, 8) graph on the card (all
    8192 sources, b = 1, sw_pad = 256): its total and diameter against
    ``certify``'s independent host recomputation and phase 7's mpl; the
    kernel against its plain version at that shape, timed with CUDA
    events, and the copy home timed apart;
21. the paper's 256-node suite through ``repro_torch.api``:
    ``run_experiment(paper_suite("256"), [stats (bw_restarts=8),
    alltoall-64KB])`` on the card, serial (the four ``suboptimal`` graphs
    searched through both BFS kernels at n = 256, s = 64; every graph's
    ``stats`` through ``apsp`` on the card): each graph's edges, diameter,
    MPL and bisection width equal to the JAX package's, each alltoall time
    within a relative 1e-9, (256,8)-Suboptimal at least 10x faster than
    (256,3)-Wagner on alltoall (Fig 10's anchor); Fig 10's eight workloads
    on (256,8)-Suboptimal within 1e-9; ``apsp`` of the degree-11
    dragonflies of Tables 5/6 (the sweep's global instantiation) against
    its plain version and pinned totals; host seconds per build and cell;
    both kernels' launches by shape, the first call at each shape held
    against its plain version bit for bit and timed beside its bound, and
    Table 1's sweep shapes timed;
22. the paper's step 4: ``optimize_layout`` of phase 21's
    (256,8)-Suboptimal graph under 16x16 mesh traffic (seed 0, 20000
    iterations; host seconds) and ``plan_elastic_remesh`` of the pinned
    (8192, 8) circulant after 64 failures (``layout_iters=4000``), each
    equal to the JAX package's plan; the 8128 survivors swept by
    ``apsp`` on the card, the first call held bit-exact against its plain
    version and timed, the copy home apart; a fleet-size survivor graph
    with an isolated vertex through ``apsp`` (an all-pad row, sentinel
    rows) against its plain version; the disconnected fallbacks on
    ``ring(256)`` (two components; an isolated survivor) against pins;
23. the collectives of ``repro_torch.comm.torchcoll``: each on 25 MiB CUDA
    tensors over NCCL at world size 1 (one GPU), through
    ``run_on_axis(..., backend="nccl")``, returning its input exactly, and
    a gloo group refusing the CUDA tensor; then 8 gloo ranks on the host, 25 MiB of float32 a
    rank: ring and recursive-doubling allreduce within 1e-5 of the plain
    sum, the ring in the Hamiltonian order of ``torus([2, 4])``,
    ``int8_ring_allreduce`` within a relative 0.05, ``flood_bcast`` from
    roots 0 and 5 on ``wagner(8)`` exact, each timed; the round counts;
24. ``benchmarks/torch_run.py --only table1,fig4,fig_routing,table2_3,table5_6``
    on the card: each module's rows (names and derived strings) equal to
    the JAX package's, fig4's and fig_routing's values within 1e-9, Table
    1 equal to the paper's D, MPL and BW; seconds per module.  Phases
    22-24 run under ``torch.profiler``: the card's busy share of them
    (phase 23's NCCL rank, a process of its own, apart).

It prints one ``{"kernels": [...]}`` JSON line (per kernel: launches on the
main paths (the BFS kernels: phases 5, 7, 19, 20, 21, 22, 23 and 24; the
model kernels: phases 13, 15 and 17),
the largest difference from the plain version, kernel, plain and library
times from CUDA events around a run of calls, and the least time the card
could take), then the
``{"ok": true, "device": {...}}`` line last.  It imports nothing of JAX or
of the JAX package ``repro``.  Without CUDA, or outside a checkout, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, the int32
# ALU rate (64 int32 lanes per SM x 132 SMs x 1.98 GHz boost clock), the
# dense bf16 tensor-core rate and the fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
SWEEP_SOURCE = "src/repro_torch/kernels/csrc/bfs_sweep.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
KERNELS = ("bfs_sweep_kernel", "minplus_patch_kernel", "flash_attention_kernel",
           "ssd_intra_chunk_kernel")
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int = 5, n: int = 10) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around ``n``
    calls enqueued back to back behind one more, so that the device is busy
    from the first event on and the host's time to launch a call hides
    behind the device's work (as it does on the main path), over ``n``; the
    median of ``reps`` such runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def bound(nbytes: float, ops: list[tuple[float, float]]) -> tuple[float, str, str]:
    """Least time the card could take (ms), what bounds it, and both terms.
    ``ops`` lists (operations, peak rate of their type) pairs."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / rate for n, rate in ops) * 1e3
    terms = f"bytes {t_bytes:.3f} ms, operations {t_ops:.3f} ms"
    if t_bytes >= t_ops:
        return t_bytes, "bytes", terms
    return t_ops, "operations", terms


def circ_nbr(n: int, offsets, kmax: int) -> np.ndarray:
    """``metrics._nbr_table`` of the circulant C_n(offsets), padded to
    ``kmax``, built without the (n, n) adjacency: each row's neighbours
    sorted, then -1."""
    v = np.arange(n)[:, None]
    cand = np.sort(np.concatenate([(v + o) % n for o in offsets]
                                  + [(v - o) % n for o in offsets], axis=1), axis=1)
    cand[:, 1:][cand[:, 1:] == cand[:, :-1]] = n  # drop repeats (o = n / 2)
    cand.sort(axis=1)
    out = np.full((n, kmax), -1, dtype=np.int32)
    deg = int((cand[0] < n).sum())
    out[:, :deg] = cand[:, :deg]
    return out


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"[1] device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path, out = _build.build()
    _build.library()
    log(f"[2] built {os.path.relpath(path, HERE)} in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_summary(out):
        log(f"    {line}")
    ops = sass_opcodes(path, "minplus_patch")
    for name, count in sorted(ops.items()):
        minmax = ", ".join(f"{op} {c}" for op, c in sorted(count.items())
                           if "MNMX" in op or op == "IADD3")
        log(f"    SASS {name}: {sum(count.values())} instructions; "
            f"{minmax or 'no min or max opcodes'}")
    # each stream instantiation patches 4 columns x M endpoints a row by
    # Hopper's fused add-min, not by an emulated add and min
    for m in (1, 2, 4, 8, 16, 32):
        fused = ops.get(f"minplus_patch_kernel<{m}>", {}).get("VIADDMNMX", 0)
        check(fused >= 4 * m, f"minplus_patch_kernel<{m}> has {fused} VIADDMNMX, "
              f"fewer than 4 x {m}")


def sass_opcodes(lib, kernel: str) -> dict:
    """Opcode counts per instantiation of ``kernel`` in ``cuobjdump -sass`` of
    the built library, keyed "name<template arguments>" (Hopper's DPX fused
    add-min is VIADDMNMX; an add and a min are IADD3 and IMNMX)."""
    from collections import Counter

    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs: dict[str, Counter] = {}
    ops = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            ops = None
            if kernel in m.group(1):
                args = ",".join(re.findall(r"Li(\d+)E", m.group(1)))
                ops = funcs.setdefault(f"{_kernel_name(m.group(1))}<{args}>", Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and ops is not None:
            ops[m.group(1)] += 1
    check(bool(funcs), f"no {kernel} function in cuobjdump -sass of {lib}")
    return funcs


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` name in a mangled symbol: the one that a length
    prefix spells out (the namespace before it carries digits too)."""
    for m in re.finditer(r"_kernel", mangled):
        for i in range(m.start(), 0, -1):
            digits = re.search(r"\d+$", mangled[:i])
            if digits and any(int(digits.group()[k:]) == m.end() - i
                              for k in range(len(digits.group()))):
                return mangled[i:m.end()]
    return mangled


def ptxas_summary(out: str) -> list[str]:
    """``nvcc -Xptxas -v``'s report in a few lines: per kernel, its
    instantiations' registers and spill stores, then every error and every
    C75xx note (ptxas reports a serialized ``wgmma`` pipeline as "info
    (C7513)", not as a warning)."""
    kernels: dict[str, list[tuple[str, int, int]]] = {}
    func, spill = "", 0
    notes = []
    for line in out.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            func = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and func:
            args = ",".join(re.findall(r"Li(\d+)E", func))
            kernels.setdefault(_kernel_name(func), []).append((args, int(m.group(1)), spill))
            func, spill = "", 0
        if "C75" in line or "error" in line.lower():
            notes.append(line.strip())
    lines = []
    for name, inst in sorted(kernels.items()):
        regs = [r for _, r, _ in inst]
        spilled = [f"<{a}> {sp} B" for a, _, sp in inst if sp]
        each = (" (" + ", ".join(f"<{a}> {r}" for a, r, _ in inst) + ")"
                if len(inst) <= 8 else "")
        lines.append(f"{name}: {len(inst)} instantiation(s), {min(regs)}-{max(regs)} "
                     f"registers{each}, spill stores: {', '.join(spilled) or 'none'}")
    lines.append(f"ptxas errors and C75xx notes: {len(notes)}")
    return lines + notes


def polish_tables(n: int, k: int, count: int, seed: int = 0,
                  fold: int = 4) -> tuple[np.ndarray, np.ndarray, list]:
    """(count, n, k) neighbour tables of graphs the polish prices at (n, k):
    the pinned circulant, then count - 1 orbit swaps of it drawn from a
    seeded Generator as a polish iteration draws them (``_draw_orbit_swap``),
    each as the swapped graph (what a full re-sweep prices) and as the
    post-removal graph (what the delta sweep prices); and each graph's
    added edges (None for the circulant), the patch that turns its
    post-removal rows into the swapped graph's."""
    from repro_torch.core.graphs import circulant
    from repro_torch.core.known_optimal import KNOWN_CIRCULANT_OFFSETS
    from repro_torch.core.search import (_circulant_orbits, _draw_orbit_swap,
                                         _PolishChain)

    s = n // fold
    offsets = KNOWN_CIRCULANT_OFFSETS[(n, k)]
    ring = {(i, (i + 1) % n) for i in range(n - 1)} | {(0, n - 1)}
    rng = np.random.default_rng(seed)
    ch = _PolishChain(rng, sorted(_circulant_orbits(n, s, offsets), key=sorted),
                      circulant(n, offsets).adjacency(), 0.05)
    full, post, added = [ch.nbr], [ch.nbr], [None]
    while len(full) < count:
        mv = _draw_orbit_swap(rng, ch.orb_list, ch.chord_edges, ring, n, s, fold)
        if mv is None:
            continue
        work = mv[5] | mv[4]  # remaining chords | new edges
        removed = sorted(ch.chord_edges - work)
        added.append(sorted(work - ch.chord_edges))
        full.append(ch.trial_nbr(removed, added[-1]))
        post.append(ch.trial_nbr(removed, ()))
    return np.stack(full), np.stack(post), added


def sweep_edge_cases() -> list[tuple[str, np.ndarray, np.ndarray, np.ndarray, int]]:
    """Small batches that reach every branch of ``bfs_sweep_kernel``, as
    (label, nb, vm, F0, sentinel) numpy arrays."""
    from repro_torch.core.known_optimal import KNOWN_CIRCULANT_OFFSETS
    from repro_torch.kernels import bfs_sweep as bs

    rng = np.random.default_rng(3)
    cases = []

    def add(label, nbrs, sources, sentinel=None):
        nb, vm, F0, _, _ = bs.pack_batch(nbrs, np.asarray(sources))
        cases.append((label, nb, vm, F0, nbrs.shape[1] if sentinel is None else sentinel))

    # kmax 5 with -1 pads in the middle of a row (degree 4 and some degree 3)
    nbr = circ_nbr(130, (1, 9), 5)
    nbr[::7, 1] = -1
    nbr = np.take_along_axis(nbr, rng.permuted(np.tile(np.arange(5), (130, 1)), axis=1), 1)
    add("kmax 5, -1 pads mid-row, n=130", nbr[None], np.arange(130))
    add("n=1000 (ragged block)", circ_nbr(1000, (1, 23, 100), 6)[None], np.arange(0, 1000, 7))
    add("n=3000 (ragged last vertex slot)", circ_nbr(3000, (1, 50, 301), 6)[None],
        rng.choice(3000, 200, replace=False))
    # a zero seed word between two others, and a source in bit 31
    nb, vm, _, _, _ = bs.pack_batch(circ_nbr(200, (1, 13), 4)[None], np.arange(1))
    F0 = np.zeros((1, 200, 3), dtype=np.uint32)
    F0[0, 17, 0] = np.uint32(1 << 31)
    F0[0, 5, 0] = 1
    F0[0, 199, 2] = 1 | np.uint32(1 << 31)
    cases.append(("zero seed word, sources in bit 31", nb, vm, F0, 200))
    add("disconnected (even offsets), n=600", circ_nbr(600, (2, 10), 4)[None],
        np.arange(0, 600, 5))
    # vm words other than 0 and 0xFFFFFFFF (no packer makes them)
    nb, vm, F0, _, _ = bs.pack_batch(circ_nbr(512, (1, 5, 77), 6)[None], np.arange(96))
    part = rng.random(vm.shape) < 0.5
    vm[part] = rng.integers(0, 2**32, size=int(part.sum()), dtype=np.uint32)
    cases.append(("vm words other than 0 and ~0, n=512", nb, vm, F0, 512))
    # more (graph, word) items than blocks: blocks take several, across graphs
    nbrs = np.stack([circ_nbr(130, (1, 2 + g % 40), 4) for g in range(40)])
    add("40 graphs x 8 words, n=130", nbrs, np.arange(130))
    add("ring, n=2000 (1000 levels)", circ_nbr(2000, (1,), 2)[None], np.arange(0, 2000, 40))
    add("kmax 12, n=2048", circ_nbr(2048, (1, 3, 17, 99, 301, 700), 12)[None], np.arange(64))
    add("n=16384, k=8", circ_nbr(16384, KNOWN_CIRCULANT_OFFSETS[(16384, 8)], 8)[None],
        np.arange(64))
    add("n=MAX_SWEEP_N", circ_nbr(bs.MAX_SWEEP_N, (1, 99, 1000, 7000), 8)[None],
        rng.choice(bs.MAX_SWEEP_N, 64, replace=False))
    return cases


def phase_sweep(n: int = 8192, k: int = 8, s: int = 2048, b: int = 32) -> dict:
    import torch

    from repro_torch.core.known_optimal import KNOWN_CIRCULANT_OFFSETS
    from repro_torch.core.search import _circulant_profile
    from repro_torch.kernels import bfs_sweep as bs

    dev = torch.device(DEV)
    errs = []

    def row(label, arrays, sentinel, plain=True, calls=10):
        """Hold the kernel against its plain version bit for bit; time the
        kernel over ``calls`` calls (none: a check only) and the plain
        version; the bound from this batch's bytes and the levels its graphs
        need."""
        nb, vm, F0 = (bs.as_words(a, dev) for a in arrays)
        got = bs.sweep(nb, vm, F0, sentinel)
        want = bs.sweep_rows_ref(nb, vm, F0, sentinel)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"bfs_sweep_kernel != sweep_rows_ref ({label})")
        errs.append(int((got - want).abs().max()))
        ms = cuda_ms(lambda: bs.sweep(nb, vm, F0, sentinel), n=calls) if calls else None
        plain_ms = (cuda_ms(lambda: bs.sweep_rows_ref(nb, vm, F0, sentinel), reps=3, n=1)
                    if plain else None)
        bb, nn, kk = nb.shape
        sw = F0.shape[2]
        # levels each graph's sources need (0 for a graph with none)
        levels = [int(got[g][got[g] < sentinel].max()) + 1
                  if bool((got[g] < sentinel).any()) else 0 for g in range(bb)]
        nbytes = (nb.numel() + vm.numel() + F0.numel() + got.numel()) * 4
        nops = sum(lv * nn * kk * sw * 2 for lv in levels)  # AND + OR per gather
        bms, by, terms = bound(nbytes, [(nops, INT32_OPS_PER_S)])
        plan = bs.sweep_plan(nn, kk)
        timing = "" if ms is None else (
            f"; kernel {ms:.4f} ms, plain "
            f"{'not timed' if plain_ms is None else f'{plain_ms:.3f} ms'}, bound {bms:.4f} ms "
            f"({terms})")
        log(f"    {label}: b={bb} n={nn} kmax={kk} sw_pad={sw}, {plan.graph} graph, "
            f"{plan.threads} threads x {plan.vpt}: bit-exact{timing}; levels "
            f"{sorted(set(levels))}")
        return got, {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}

    log("[3] bfs_sweep_kernel against sweep_rows_ref, bit for bit")
    # the shapes the polish launches: the full re-sweep of 32 (8192, 8)
    # graphs from all 2048 representative rows (delta=False every
    # iteration; delta=True when one proposal of a dispatch needs a full
    # rebuild), and the delta sweep of 32 post-removal graphs, 0-47
    # affected rows each; this full-shape row is the kernel's row
    full, post, _ = polish_tables(n, k, b)
    nb, vm, F0, sw_pad, _ = bs.pack_batch(full, np.arange(s))
    got, main_row = row(f"polish full shape ({k}-regular swaps of the pinned circulant)",
                        (nb, vm, F0), n)
    mpl_c, _ = _circulant_profile(n, KNOWN_CIRCULANT_OFFSETS[(n, k)])
    # independent of both: every row of a circulant sums to (n - 1) * MPL
    check(int(got[0, :s].sum(dtype=torch.int64)) == s * round(mpl_c * (n - 1)),
          "pinned circulant rows disagree with the host profile")
    del got
    rng = np.random.default_rng(0)
    srcs = [np.sort(rng.choice(s, size=int(rng.integers(0, 48)), replace=False))
            for _ in range(b)]
    srcs[5] = np.empty(0, dtype=np.int64)
    nb, vm, F0, _, _, _ = bs.pack_delta_batch(post, srcs, s)
    row("polish delta shape (post-removal tables)", (nb, vm, F0), n)

    # the symmetric polish (replicas=1) sweeps one graph at a time: a swap's
    # affected rows on its post-removal graph (up to 32 rows: sw_pad 1; up
    # to 64: sw_pad 2; 481-512: sw_pad 16) and, on a full rebuild, all 2048
    # rows of the swapped graph (sw_pad 64)
    rng = np.random.default_rng(1)
    for m in (24, 48, 500):
        nb, vm, F0, _, _ = bs.pack_batch(post[1:2], np.sort(rng.choice(s, m, replace=False)))
        row(f"symmetric polish, {m} affected rows (a post-removal table)", (nb, vm, F0), n)
    nb, vm, F0, _, _ = bs.pack_batch(full[1:2], np.arange(s))
    row("symmetric polish, full rebuild (a swapped table)", (nb, vm, F0), n)

    # the rows this script timed first, kept for continuity: the pinned (8192, 8)
    # circulant and three more graphs from 2048 sources (the fourth graph is
    # disconnected: a bit-exactness check, not a shape the polish prices),
    # and a delta batch of degree-8, 6 and 4 circulants
    offsets = [KNOWN_CIRCULANT_OFFSETS[(n, 8)], KNOWN_CIRCULANT_OFFSETS[(n, 6)],
               KNOWN_CIRCULANT_OFFSETS[(n, 4)], (2, 4, 6, 8)]
    nbrs = np.stack([circ_nbr(n, o, k) for o in offsets])
    nb, vm, F0, _, _ = bs.pack_batch(nbrs, np.arange(s))
    got, _ = row("full batch (four graphs, one disconnected)", (nb, vm, F0), n, plain=False,
                 calls=1)
    check(bool((got[3, :s] == n).any()) and not bool((got[0, :s] == n).any()),
          "sentinel rows wrong")
    del got
    rng = np.random.default_rng(0)
    srcs = [np.sort(rng.choice(s, size=int(rng.integers(0, 48)), replace=False))
            for _ in range(32)]
    srcs[5] = np.empty(0, dtype=np.int64)
    nb, vm, F0, _, _, _ = bs.pack_delta_batch(nbrs[np.arange(32) % 3], srcs, s)
    row("delta batch (degree-8, 6 and 4 circulants)", (nb, vm, F0), n)

    # every branch of the kernel, checked only (small shapes time the host's
    # launch, not the card)
    log("    edge cases:")
    for label, nb, vm, F0, sentinel in sweep_edge_cases():
        row(label, (nb, vm, F0), sentinel, plain=False, calls=0)
    return {"name": "bfs_sweep_kernel", "route": "cuda", "source": SWEEP_SOURCE,
            "replaces": "src/repro/kernels/bfs_sweep.py:133", "max_abs_err": max(errs),
            **main_row, "library_ms": None}


def patch_inputs(rng, b: int, s: int, n: int, mmax: int,
                 inf_share: float = 0.25) -> tuple[np.ndarray, ...]:
    """(dist, tmp, crows) int32 numpy arrays of hop counts below 16 and tmp
    terms below 24, a share of them masked (``PATCH_INF``)."""
    from repro_torch.kernels import bfs_sweep as bs

    dist = rng.integers(0, 16, (b, s, n), dtype=np.int32)
    tmp = rng.integers(1, 24, (b, s, mmax), dtype=np.int32)
    tmp[rng.random(tmp.shape) < inf_share] = bs.PATCH_INF
    crows = rng.integers(0, 16, (b, mmax, n), dtype=np.int32)
    return dist, tmp, crows


def patch_edge_cases() -> list[tuple[str, np.ndarray, np.ndarray, np.ndarray, bool]]:
    """Shapes and values at the edges of ``minplus_patch_kernel``'s
    instantiations, as (label, dist, tmp, crows, whether the patch must
    leave dist as it is)."""
    from repro_torch.kernels import bfs_sweep as bs

    rng = np.random.default_rng(5)
    cases = []
    for mmax in (1, 2, 3, 4, 32, 64):
        cases.append((f"mmax={mmax}", *patch_inputs(rng, 3, 96, 2048, mmax), False))
    for n in (130, 1001):
        cases.append((f"n={n} (n % 4 != 0)", *patch_inputs(rng, 2, 40, n, 8), False))
    for n in (1000, 3000):
        cases.append((f"n={n} (a strip cut short)", *patch_inputs(rng, 2, 50, n, 16), False))
    for s in (1, 7):
        cases.append((f"s={s} (a ragged run)", *patch_inputs(rng, 3, s, 8192, 16), False))
    cases.append(("b=1", *patch_inputs(rng, 1, 300, 4096, 16), False))
    dist, tmp, crows = patch_inputs(rng, 2, 64, 2048, 16)
    tmp[:] = bs.PATCH_INF
    cases.append(("tmp all PATCH_INF", dist, tmp, crows, True))
    # the largest sums the polish can make: tmp up to two PATCH_INF terms,
    # crows and dist at the sentinel n (2 * PATCH_INF + n, inside int32)
    n = 4096
    dist = np.full((2, 64, n), n, dtype=np.int32)
    tmp = np.full((2, 64, 16), 2 * bs.PATCH_INF, dtype=np.int32)
    crows = np.full((2, 16, n), n, dtype=np.int32)
    cases.append(("sentinel dist, tmp + crows = 2 PATCH_INF + n", dist, tmp, crows, True))
    return cases


def phase_patch(b: int = 32, s: int = 2048, n: int = 8192, k: int = 8) -> dict:
    """minplus_patch_kernel against its plain version, bit for bit: timed at
    the polish's shape (mmax = 16) and at mmax = 8, beside the tile
    instantiation at the same shapes and a copy of the state; on real
    priced (8192, 8) states; then at its edge cases (checked, not timed)."""
    import torch

    from repro_torch.kernels import bfs_sweep as bs

    dev = torch.device(DEV)
    errs = []

    def run(label, dist, tmp, crows, unchanged=False):
        """Hold the kernel against its plain version bit for bit; log the
        instantiation patch_plan gave it."""
        got = bs.patch_apply(dist, tmp, crows)
        want = bs.patch_apply_ref(dist, tmp, crows)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"minplus_patch_kernel != patch_apply_ref ({label})")
        check(torch.equal(got, dist) == unchanged,
              f"the patch {'changed' if unchanged else 'left'} dist ({label})")
        errs.append(int((got - want).abs().max()))
        aligned = all(t.data_ptr() % 16 == 0 for t in (dist, tmp, crows))
        plan = bs.patch_plan(*dist.shape, crows.shape[1], aligned)
        ring = (f"{plan.strip}-column strips, {plan.stages} stages of {plan.rows} rows"
                if plan.kind == "stream" else f"{plan.rows} x {plan.strip} tiles")
        log(f"    {label}: b, s, n = {tuple(dist.shape)} mmax={crows.shape[1]}, {plan.kind} "
            f"(mmax {plan.mmax}, {plan.threads} threads, {ring}, {plan.smem_bytes} B): "
            f"bit-exact")
        return got

    def timed(mmax, copy, b=b):
        gen = torch.Generator(device=DEV).manual_seed(0)
        dist = torch.randint(0, 16, (b, s, n), generator=gen, device=DEV, dtype=torch.int32)
        tmp = torch.randint(1, 24, (b, s, mmax), generator=gen, device=DEV, dtype=torch.int32)
        tmp[:, :, mmax - 3:] = int(bs.PATCH_INF)  # masked endpoint slots
        crows = torch.randint(0, 16, (b, mmax, n), generator=gen, device=DEV,
                              dtype=torch.int32)
        exact = run(f"timed, mmax={mmax}", dist, tmp, crows)
        ms = cuda_ms(lambda: bs.patch_apply(dist, tmp, crows))
        # the tile instantiation at the same shape (the first design)
        out = torch.empty_like(dist)
        tile = bs.patch_plan(b, s, n, mmax, aligned=False)
        bs._launch_patch(dist, tmp, crows, out, tile)
        torch.cuda.synchronize()
        check(torch.equal(out, exact), f"tile instantiation != patch_apply_ref (mmax={mmax})")
        tile_ms = cuda_ms(lambda: bs._launch_patch(dist, tmp, crows, out, tile))
        plain_ms = cuda_ms(lambda: bs.patch_apply_ref(dist, tmp, crows), reps=3, n=1)
        # the card's practical streaming rate: a copy of the same state
        copy_ms = cuda_ms(lambda: out.copy_(dist)) if copy else None
        nbytes = (2 * dist.numel() + tmp.numel() + crows.numel()) * 4
        # add + min per element and endpoint
        bms, by, terms = bound(nbytes, [(2 * b * s * n * mmax, INT32_OPS_PER_S)])
        copied = "" if copy_ms is None else (
            f", out.copy_(dist) of {dist.numel() * 4 / 1e9:.2f} GB {copy_ms:.4f} ms")
        log(f"[4] patch b={b} s={s} n={n} mmax={mmax}: kernel {ms:.4f} ms, tile instantiation "
            f"{tile_ms:.4f} ms, plain {plain_ms:.3f} ms{copied}; bound {bms:.4f} ms ({terms})")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}

    log("[4] minplus_patch_kernel against patch_apply_ref, bit for bit")
    main_row = timed(16, True)  # the polish's shape: two orbits of 4 edges, 16 endpoints
    timed(8, False)
    timed(16, False, b=1)  # the symmetric polish (replicas=1): one proposal at a time

    # real priced states: the post-removal rows of the pinned circulant and
    # orbit swaps of it, patched with their added edges through
    # patch_prologue, must be the swapped graphs' rows
    full, post, added = polish_tables(n, k, b)
    sweep_rows = lambda tables: bs.sweep(*(bs.as_words(a, dev)
                                           for a in bs.pack_batch(tables, np.arange(s))[:3]), n)
    state = sweep_rows(post).contiguous()  # (the plain sweep's rows are a transposed view)
    tmp, crows = bs.patch_prologue(state, *(torch.from_numpy(a).to(dev)
                                            for a in bs.pack_patch(added, s)))
    got = run(f"real priced ({n}, {k}) states", state, tmp, crows)
    check(torch.equal(got, sweep_rows(full)), "patched post-removal rows != swapped graphs' rows")
    del state, tmp, crows, got

    log("    edge cases:")
    for label, dist, tmp, crows, unchanged in patch_edge_cases():
        run(label, *(torch.from_numpy(a).to(dev) for a in (dist, tmp, crows)), unchanged)
    # tensors that are not 16-byte aligned: dist a view 4 bytes into its storage
    dist, tmp, crows = patch_inputs(np.random.default_rng(6), 2, 64, 1024, 16)
    flat = torch.empty(dist.size + 1, dtype=torch.int32, device=dev)
    view = flat[1:].view(dist.shape)
    view.copy_(torch.from_numpy(dist))
    run("unaligned dist (4 bytes into its storage)", view,
        *(torch.from_numpy(a).to(dev) for a in (tmp, crows)))
    return {"name": "minplus_patch_kernel", "route": "cuda", "source": SWEEP_SOURCE,
            "replaces": "src/repro/kernels/bfs_sweep.py:361", "max_abs_err": max(errs),
            **main_row, "library_ms": None}


def _fields(res) -> tuple:
    return (res.graph.edges, res.mpl, res.diameter, res.accepted, res.history,
            res.evals_delta, res.evals_full, res.device_dispatches, res.replicas,
            res.offsets)


def recheck(res, n: int, k: int, fold: int, warm: float) -> None:
    """Recheck a search result from scratch with the sweep over all n/fold
    representative rows of the returned graph: its MPL and diameter, k-regular,
    invariant under rotation by n/fold, and mpl_lb <= mpl <= ``warm`` (the
    warm start's MPL)."""
    from repro_torch.core import metrics
    from repro_torch.kernels import bfs_sweep as bs

    s = n // fold
    g = res.graph
    rows = bs.bfs_rows(metrics._nbr_table(g.adjacency()), np.arange(s), n,
                       device=DEV)
    total = rows.sum(dtype=np.int64)
    check(int(rows.max()) < n, "returned graph is disconnected")
    check(total / (s * (n - 1)) == res.mpl, "recomputed MPL differs from the reported")
    check(float(rows.max()) == res.diameter, "recomputed diameter differs")
    check(g.is_regular() and g.degree() == k, "result is not k-regular")
    es = set(g.edges)
    check(all((min((u + s) % n, (v + s) % n), max((u + s) % n, (v + s) % n)) in es
              for u, v in es), "result is not invariant under rotation by n/fold")
    check(res.mpl_lb <= res.mpl <= warm, "mpl outside [mpl_lb, warm start]")
    log(f"    recheck: mpl and diameter reproduced from {s} fresh BFS rows; "
        f"{k}-regular, rotation-invariant; warm start mpl={warm!r}")


def phase_main(n: int = 8192, k: int = 8, fold: int = 4, replicas: int = 8,
               proposal_batch: int = 4, polish_iters: int = 32) -> dict:
    import torch

    from repro_torch.core.engines import cuda_sweep
    from repro_torch.core.known_optimal import KNOWN_CIRCULANT_OFFSETS
    from repro_torch.core.search import _circulant_profile, large_search

    kw = dict(seed=0, fold=fold, replicas=replicas, proposal_batch=proposal_batch)
    # wall time inside the pricing dispatches (each ends in a device->host copy)
    spent = {"dispatch_s": 0.0, "dispatches": 0}
    orig = cuda_sweep.sharded_delta_state

    def timed(*a, **k2):
        t = time.perf_counter()
        out = orig(*a, **k2)
        spent["dispatch_s"] += time.perf_counter() - t
        spent["dispatches"] += 1
        return out

    cuda_sweep.sharded_delta_state = timed
    try:
        _reset_search_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = large_search(n, k, polish_iters=polish_iters, delta=True,
                           device=DEV, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, shapes, patch_shapes = _search_counts()
    finally:
        cuda_sweep.sharded_delta_state = orig
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[5] large_search({n}, {k}, replicas={replicas}, proposal_batch="
        f"{proposal_batch}, polish_iters={polish_iters}, delta=True) on {DEV}: "
        f"wall {wall:.2f} s, {spent['dispatches']} dispatches took "
        f"{spent['dispatch_s']:.2f} s, peak device memory {peak:.2f} GiB")
    log(f"    mpl={float(res.mpl)!r} diameter={res.diameter} mpl_lb={res.mpl_lb!r} "
        f"accepted={res.accepted} evals_delta={res.evals_delta} "
        f"evals_full={res.evals_full} device_dispatches={res.device_dispatches} "
        f"launches={launches}")
    log(f"    bfs_sweep_kernel launches by (b, sw_pad): {shapes}")
    log(f"    minplus_patch_kernel launches by (b, mmax): {patch_shapes}")
    check(launches["bfs_sweep_kernel"] > 0 and launches["minplus_patch_kernel"] > 0,
          f"main path did not launch both kernels: {launches}")
    # two orbits of fold edges a proposal: 2 * 2 * fold endpoints, the shape
    # phase 4 times
    check(max(patch_shapes, key=patch_shapes.get) == (replicas * proposal_batch, 4 * fold),
          f"the polish's most frequent patch shape is not (b, 4 * fold): {patch_shapes}")

    warm, _ = _circulant_profile(n, KNOWN_CIRCULANT_OFFSETS[(n, k)])
    recheck(res, n, k, fold, warm)

    # delta=False (sharded_rows_totals) follows the delta=True trajectory;
    # the two pricings are timed in turns (full, delta, delta, full)
    walls = {False: [], True: []}
    runs = {}
    for delta in (False, True, True, False):
        t0 = time.perf_counter()
        r = large_search(n, k, polish_iters=8, delta=delta, device=DEV, **kw)
        walls[delta].append(time.perf_counter() - t0)
        runs[delta] = (r.graph.edges, r.mpl, r.diameter, r.history, r.accepted)
    check(runs[False] == runs[True], "delta=False and delta=True trajectories differ")
    log(f"    8 iterations: delta=False {walls[False]} s, delta=True {walls[True]} s, "
        f"same trajectory (mpl={float(runs[True][1])!r}, accepted={runs[True][4]})")
    for delta in (False, True):
        profile_run(lambda: large_search(n, k, polish_iters=8, delta=delta,
                                         device=DEV, **kw), f"8 iterations, delta={delta}")
    return launches


def profile_run(fn, label: str, top: int = 6) -> tuple[float, float]:
    """Device time of one run by kernel (torch.profiler), against its wall
    time: how much of the run keeps the card busy.  Returns the device's
    busy seconds and the wall seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t_stop = time.perf_counter()
    # the trace's events are parsed and grouped with the cyclic collector
    # off: its full passes over this long-lived process's heap are not the
    # profiler's work
    gc_on = gc.isenabled()
    gc.disable()
    try:
        n_events = len(prof.events())
        t_parse = time.perf_counter()
        averages = prof.key_averages()
    finally:
        if gc_on:
            gc.enable()
    # device-side events only (kernels, copies, memsets), as torch's own
    # table totals them, so no time is counted twice
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in averages
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"    profiled {label}: device busy {busy:.3f} s of "
        f"{wall:.2f} s wall ({100 * busy / wall:.1f}%); the profiler's own start "
        f"{t0 - t_start:.2f} s, stop {t_stop - t0 - wall:.2f} s, {n_events} events "
        f"parsed {t_parse - t_stop:.2f} s, grouped {time.perf_counter() - t_parse:.2f} s; "
        f"top device time:")
    for us, count, key in rows[:top]:
        log(f"      {us / 1e3:10.2f} ms  x{count:<5d} {key[:72]}")
    # each hand-written kernel by name, in the top rows or not
    for name in KERNELS:
        hit = [(us, count) for us, count, key in rows if re.search(rf"\b{name}\b", key)]
        log(f"      {sum(h[0] for h in hit) / 1e3:10.2f} ms  x{sum(h[1] for h in hit):<5d} "
            f"{name} (all instantiations)")
    return busy, wall


def phase_card_vs_cpu() -> None:
    from repro_torch.core.search import large_search

    kw = dict(seed=0, fold=4, replicas=4, proposal_batch=2, polish_iters=8)
    t0 = time.perf_counter()
    a = large_search(2048, 6, device=DEV, **kw)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = large_search(2048, 6, device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    check(_fields(a) == _fields(b), "card and CPU paths differ at (2048, 6)")
    log(f"[6] large_search(2048, 6) card == CPU in every field (mpl={float(a.mpl)!r}, "
        f"accepted={a.accepted}); cuda {t_gpu:.2f} s, cpu {t_cpu:.2f} s")


def _reset_search_counts() -> None:
    from repro_torch.kernels import bfs_sweep as bs

    bs.sweep.launches = bs.patch_apply.launches = 0
    bs.sweep.shapes.clear()
    bs.patch_apply.shapes.clear()


def _search_counts() -> tuple[dict, dict, dict]:
    """Both BFS kernels' launches, and their launches by (b, sw_pad) and by
    (b, mmax)."""
    from repro_torch.kernels import bfs_sweep as bs

    return ({"bfs_sweep_kernel": bs.sweep.launches,
             "minplus_patch_kernel": bs.patch_apply.launches},
            dict(sorted(bs.sweep.shapes.items())), dict(sorted(bs.patch_apply.shapes.items())))


# the symmetric polish's sweep shapes phase 3 times at b = 1: up to 32, up
# to 64 and 481-512 affected rows, and a full rebuild of 2048 rows
SYMMETRIC_SWEEP_SHAPES = ((1, 1), (1, 2), (1, 16), (1, 64))


def phase_symmetric(n: int = 8192, k: int = 8, fold: int = 4,
                    polish_iters: int = 200) -> tuple[dict, object]:
    """The default large-N call, replicas=1: the circulant warm start, then
    ``symmetric_sa_search`` priced by ``SymmetricAPSP`` on the card.  Returns
    both BFS kernels' launches and the search result."""
    import torch

    from repro_torch.core import metrics
    from repro_torch.core.known_optimal import KNOWN_CIRCULANT_OFFSETS
    from repro_torch.core.search import _circulant_profile, large_search

    # host time inside the evaluator (evaluate_swap ends in a device->host
    # copy of the row sums) and the bytes each evaluation copies
    spent = {"evaluate_swap": 0.0, "commit": 0.0, "evals": 0, "commits": 0,
             "max_to_host": 0, "max_to_device": 0}
    evs = []
    orig_eval, orig_commit = metrics.SymmetricAPSP.evaluate_swap, metrics.SymmetricAPSP.commit

    def timed_eval(ev, *a):
        if ev not in evs:
            evs.append(ev)
        before = (ev.bytes_to_host, ev.bytes_to_device)
        t = time.perf_counter()
        out = orig_eval(ev, *a)
        spent["evaluate_swap"] += time.perf_counter() - t
        spent["evals"] += 1
        spent["max_to_host"] = max(spent["max_to_host"], ev.bytes_to_host - before[0])
        spent["max_to_device"] = max(spent["max_to_device"], ev.bytes_to_device - before[1])
        return out

    def timed_commit(ev, tok):
        t = time.perf_counter()
        orig_commit(ev, tok)
        spent["commit"] += time.perf_counter() - t
        spent["commits"] += 1

    metrics.SymmetricAPSP.evaluate_swap = timed_eval
    metrics.SymmetricAPSP.commit = timed_commit
    try:
        _reset_search_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = large_search(n, k, seed=0, fold=fold, polish_iters=polish_iters, device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, shapes, patch_shapes = _search_counts()
    finally:
        metrics.SymmetricAPSP.evaluate_swap = orig_eval
        metrics.SymmetricAPSP.commit = orig_commit
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(len(evs) == 1, f"expected one evaluator, got {len(evs)}")
    ev = evs[0]
    state = (n // fold) * n * 4
    log(f"[7] large_search({n}, {k}, seed=0, fold={fold}, polish_iters={polish_iters}), "
        f"replicas=1, on {DEV}: wall {wall:.2f} s; evaluate_swap {spent['evaluate_swap']:.2f} s "
        f"over {spent['evals']} calls, commit {spent['commit']:.4f} s over {spent['commits']}; "
        f"peak device memory {peak:.2f} GiB")
    log(f"    mpl={float(res.mpl)!r} diameter={res.diameter} mpl_lb={res.mpl_lb!r} "
        f"accepted={res.accepted} evals_delta={res.evals_delta} evals_full={res.evals_full} "
        f"replicas={res.replicas} launches={launches}")
    log(f"    copies: host->device {ev.bytes_to_device} B, device->host {ev.bytes_to_host} B "
        f"in all ({ev.bytes_to_device / polish_iters:.0f} and "
        f"{ev.bytes_to_host / polish_iters:.0f} B an iteration; the most one evaluation "
        f"copied: {spent['max_to_device']} and {spent['max_to_host']} B), against a "
        f"{state} B state")
    log(f"    bfs_sweep_kernel launches by (b, sw_pad): {shapes}")
    log(f"    minplus_patch_kernel launches by (b, mmax): {patch_shapes}")
    # the result is the polish's, or the warm start's if the polish found
    # nothing better
    check(spent["evals"] > 0 and res.replicas == 1
          and res.evals_delta + res.evals_full in (0, spent["evals"]),
          "the polish was not the symmetric one")
    check(launches["bfs_sweep_kernel"] > 0 and launches["minplus_patch_kernel"] > 0,
          f"the symmetric polish did not launch both kernels: {launches}")
    check(spent["max_to_host"] < state // 16,
          f"an evaluation copied {spent['max_to_host']} B home, not well under the state")
    check(max(shapes, key=shapes.get) in SYMMETRIC_SWEEP_SHAPES,
          f"the symmetric polish's most frequent sweep shape is not timed: {shapes}")
    # two orbits of fold edges a proposal: 2 * 2 * fold endpoints, the shape
    # phase 4 times at b = 1
    check(max(patch_shapes, key=patch_shapes.get) == (1, 4 * fold),
          f"the symmetric polish's most frequent patch shape is not (1, 4 * fold): "
          f"{patch_shapes}")
    warm, _ = _circulant_profile(n, KNOWN_CIRCULANT_OFFSETS[(n, k)])
    recheck(res, n, k, fold, warm)
    profile_run(lambda: large_search(n, k, seed=0, fold=fold, polish_iters=20, device=DEV),
                "20 iterations, replicas=1")
    return launches, res



# the paper's named topologies at N <= 36 (tests/test_golden.py): constructor
# name and arguments, n, k, diameter, exact total hops, bisection width
GOLDEN = (
    ("(16,2)-Ring", "ring", (16,), 16, 2, 8, 1024, 2),
    ("(16,3)-Wagner", "wagner", (16,), 16, 3, 4, 624, 4),
    ("(16,3)-Bidiakis", "bidiakis", (16,), 16, 3, 5, 608, 4),
    ("(16,4)-Torus", "torus", ([4, 4],), 16, 4, 4, 512, 8),
    ("(32,2)-Ring", "ring", (32,), 32, 2, 16, 8192, 2),
    ("(32,3)-Wagner", "wagner", (32,), 32, 3, 8, 4576, 4),
    ("(32,3)-Bidiakis", "bidiakis", (32,), 32, 3, 9, 4032, 4),
    ("(32,4)-Torus", "torus", ([4, 8],), 32, 4, 6, 3072, 8),
    ("(32,4)-Chvatal", "chvatal32", (), 32, 4, 4, 2532, 8),
    ("(12,4)-Chvatal", "chvatal", (), 12, 4, 2, 216, 8),
    ("(12,3)-Bidiakis", "bidiakis", (12,), 12, 3, 3, 268, 4),
    ("(20,4)-Dragonfly", "dragonfly", (4, 5, 1), 20, 4, 3, 860, 8),
    ("(30,5)-Dragonfly", "dragonfly", (5, 6, 1), 30, 5, 3, 2070, 9),
    ("(36,5)-Dragonfly", "dragonfly", (4, 9, 2), 36, 5, 3, 2952, 20),
)
# Algorithm 1 at the paper's Table 1 sizes (tests/test_search.py): the MPL
# it must reach (1.75 is 0.0167 above the (16, 4) Cerf bound of 1.7333;
# 2.36 is the paper's 2.35 to two decimals) and the reference's MPL with
# these arguments (2.3548387... is the (32, 4) Cerf bound itself)
TABLE1_SA = (((16, 4), 1.75, 1.75), ((32, 4), 2.36, 2.3548387096774195))


def _apsp_on_card(g, metrics) -> np.ndarray:
    """``metrics.apsp`` of ``g`` on the card, held equal to its plain
    version (the sweep's plain PyTorch version on the CPU); returns the
    card's distances."""
    d = metrics.apsp(g, device=DEV)
    check(np.array_equal(d, metrics.apsp(g, device="cpu")),
          f"apsp on the card differs from its plain version ({g.name})")
    return d


def phase_table1() -> dict:
    """Table 1 and Algorithm 1 on the card's machine: the golden rows through
    ``apsp`` on the card, ``bisection_width`` and ``certify``;
    ``exhaustive_search(12, 3)``; ``sa_search`` at (16, 4) and (32, 4), its
    graphs rechecked on the card.  Returns both BFS kernels' launches."""
    from repro_torch.core import certify, graphs, metrics, search
    from repro_torch.kernels import bfs_sweep as bs

    log("[19] Table 1 and Algorithm 1: golden rows through apsp on the card, "
        "bisection_width and certify")
    _reset_search_counts()
    t0 = time.perf_counter()
    for name, fn, args, n, k, diam, total, bw in GOLDEN:
        g = getattr(graphs, fn)(*args)
        check(g.n == n and g.is_regular() and g.degree() == k, f"{name}: not ({n},{k})")
        d = _apsp_on_card(g, metrics)
        got_total = int(d[~np.eye(n, dtype=bool)].sum())
        check(got_total == total and metrics.diameter(g, d) == diam,
              f"{name}: total {got_total}, diameter {metrics.diameter(g, d)}; "
              f"pinned {total}, {diam}")
        check(metrics.mpl(g, d) == total / (n * (n - 1)), f"{name}: mpl")
        got_bw = metrics.bisection_width(g, restarts=24, seed=0)
        cert = certify.certify(g, bisection=True)
        check(got_bw == bw and (cert.total_hops, cert.diameter, cert.bisection)
              == (total, diam, bw), f"{name}: bisection {got_bw}, certificate {cert}")
        log(f"    {name}: total {total}, diameter {diam}, mpl {total / (n * (n - 1)):.4f}, "
            f"bisection {bw}; sweep plan {bs.sweep_plan(n, k).graph} "
            f"({bs.sweep_plan(n, k).threads} threads): card == plain == pinned == certify")
    log(f"    14 golden rows in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    ex = search.exhaustive_search(12, 3)
    t_ex = time.perf_counter() - t0
    d = _apsp_on_card(ex.graph, metrics)
    check(ex.iterations == 3326 and ex.mpl == ex.mpl_lb == 252 / 132 and ex.diameter == 3
          and metrics.mpl(ex.graph, d) == ex.mpl and ex.graph.degree() == 3,
          f"exhaustive_search(12, 3): mpl {ex.mpl!r}, {ex.iterations} candidates")
    log(f"    exhaustive_search(12, 3): {ex.iterations} candidates in {t_ex:.2f} s (host), "
        f"mpl {float(ex.mpl)!r} = its Cerf bound, diameter {ex.diameter}")

    for (n, k), limit, ref_mpl in TABLE1_SA:
        t0 = time.perf_counter()
        res = search.sa_search(n, k, seed=0, n_iter=4000, replicas=4)
        secs = time.perf_counter() - t0
        g = res.graph
        d = _apsp_on_card(g, metrics)
        ring_edges = {(min(i, (i + 1) % n), max(i, (i + 1) % n)) for i in range(n)}
        check(g.is_regular() and g.degree() == k and ring_edges <= set(g.edges),
              f"sa_search({n}, {k}): not a Hamiltonian {k}-regular graph")
        check(metrics.mpl(g, d) == res.mpl and metrics.diameter(g, d) == res.diameter,
              f"sa_search({n}, {k}): reported mpl/diameter differ from the card's apsp")
        check(res.mpl <= limit + 1e-9 and res.mpl == ref_mpl,
              f"sa_search({n}, {k}): mpl {res.mpl!r}, the paper's <= {limit}, "
              f"the reference's {ref_mpl!r}")
        log(f"    sa_search({n}, {k}, seed=0, n_iter=4000, replicas=4): {secs:.2f} s on the "
            f"host; mpl {res.mpl!r} (<= {limit}, equal to the reference's), Cerf bound "
            f"{res.mpl_lb!r}, diameter {res.diameter}, accepted {res.accepted}, "
            f"evals_delta {res.evals_delta}, evals_full {res.evals_full}")
    launches, shapes, _ = _search_counts()
    log(f"    bfs_sweep_kernel launches by (b, sw_pad): {shapes}")
    check(launches["bfs_sweep_kernel"] == len(GOLDEN) + 1 + len(TABLE1_SA),
          f"one sweep per graph expected: {launches}")
    return launches


def phase_whole_graph(res) -> dict:
    """``apsp_hops`` of the graph phase 7 found, on the card: every one of
    its n sources swept at once (b = 1, sw_pad = n / 32), the kernel timed
    with CUDA events and the copy home apart, held against its plain
    version on the card, ``certify``'s independent host recomputation and
    phase 7's mpl and diameter.  Returns both BFS kernels' launches."""
    import torch

    from repro_torch.core import certify, metrics
    from repro_torch.kernels import bfs_sweep as bs

    g = res.graph
    n = g.n
    adj = g.adjacency()
    _reset_search_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hops = metrics.apsp_hops(adj, device=DEV)
    t_call = time.perf_counter() - t0
    launches, shapes, _ = _search_counts()
    total, diam = int(hops.sum(dtype=np.int64)), int(hops.max())
    t0 = time.perf_counter()
    cert = certify.certify(g)
    t_cert = time.perf_counter() - t0
    log(f"[20] apsp_hops of phase 7's ({n}, {g.degree()}) graph on the card: "
        f"{t_call:.3f} s a call (neighbour table, upload, kernel, {hops.nbytes} B home); "
        f"total {total}, diameter {diam}; certify on the host {t_cert:.2f} s: total "
        f"{cert.total_hops}, diameter {cert.diameter}; launches by (b, sw_pad) {shapes}")
    check(cert.connected and (total, diam) == (cert.total_hops, cert.diameter),
          "apsp_hops on the card disagrees with certify")
    check(total / (n * (n - 1)) == res.mpl and float(diam) == res.diameter,
          "apsp_hops on the card disagrees with phase 7's mpl and diameter")
    check(launches["bfs_sweep_kernel"] == 1, f"one sweep expected: {launches}")

    # the same sweep by its parts: the kernel (CUDA events) and the copy home
    dev = torch.device(DEV)
    nb, vm, F0, sw_pad, _ = bs.pack_batch(metrics._nbr_table(adj)[None], np.arange(n))
    nb, vm, F0 = (bs.as_words(a, dev) for a in (nb, vm, F0))
    out = bs.sweep(nb, vm, F0, n)
    check(torch.equal(out, bs.sweep_rows_ref(nb, vm, F0, n)),
          "bfs_sweep_kernel != sweep_rows_ref at the whole-graph shape")
    check(np.array_equal(out[0].cpu().numpy(), hops), "the sweep's rows differ from apsp_hops")
    ms = cuda_ms(lambda: bs.sweep(nb, vm, F0, n), reps=3, n=5)
    plain_ms = cuda_ms(lambda: bs.sweep_rows_ref(nb, vm, F0, n), reps=3, n=1)
    copies = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.cpu()
        copies.append((time.perf_counter() - t0) * 1e3)
    nbytes = (nb.numel() + vm.numel() + F0.numel() + out.numel()) * 4
    nops = (diam + 1) * n * nb.shape[2] * sw_pad * 2  # AND + OR per gather, each level
    bms, by, terms = bound(nbytes, [(nops, INT32_OPS_PER_S)])
    plan = bs.sweep_plan(n, nb.shape[2])
    log(f"    bfs_sweep_kernel at b=1, n={n}, kmax={nb.shape[2]}, sw_pad={sw_pad} "
        f"({plan.graph} graph, {plan.threads} threads x {plan.vpt}): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({terms}), bit-exact against its "
        f"plain version; copy home of "
        f"{out.numel() * 4} B {float(np.median(copies)):.2f} ms (host clock, median of 3)")
    return launches


# Table 4 and Fig 10 of the paper at 256 nodes (paper_suite("256")), as the
# JAX package computes them on a CPU: sha256 of the edge list (JSON of
# [u, v] pairs), diameter, MPL, bisection width (stats, bw_restarts=8) and
# the alltoall time at 64 KB per pair (the TAISHAN model, seconds)
SUITE256 = {
    "(256,2)-Ring": ("e18180daa2da1aee31f04952ab5bdcd3ce15b3cfd19f2c91445bbd32d998c061",
                     128, 64.25098039215686, 2, 11.111756933050843),
    "(256,3)-Wagner": ("46b80144f9db21f7b82e7ce6876c645c9c0c07bcbd79fbe595ed4b41866283e6",
                       64, 32.62352941176471, 4, 7.8248158779661035),
    "(256,3)-Bidiakis": ("374978dda4bf2f0cf8c3a0387e9fe8a9373c655ce85cd3f9fdd6f51cc9985988",
                         65, 25.090196078431372, 4, 7.924837778813556),
    "(256,3)-Suboptimal": ("fc8a231b628b823a4c6398115857cb0e89ebb86b0d88acac2cc681b39a4e2f46",
                           9, 5.768198529411765, 46, 1.4594952372881371),
    "(256,4)-Torus": ("048d8df11dccac0ac722042f645ba06bf51acad398760e60db0dcbc40e535b48",
                      16, 8.031372549019608, 32, 3.2224398550847453),
    "(256,4)-Suboptimal": ("4e501757fabccbb53942d2f7ff835122ed9a6da226605abcdae13bb4034d4f32",
                           6, 4.214950980392157, 92, 1.0444005144067803),
    "(256,6)-Torus": ("ea15f973b63172102af39f035276981d850a09c31860e18f76e9c7fd3b3c853c",
                      10, 5.019607843137255, 64, 1.649734570338985),
    "(256,6)-Suboptimal": ("dd3ed492058d64d30b8463e2d9599b0e1df5d39c733cf3e4f271891db60d4c12",
                           5, 3.238357843137255, 182, 0.764333454237289),
    "(256,8)-Torus": ("55f08252ebbd783d4d6ac5c5aff67d8be4be48d5e7f74b572368f521e61d2de3",
                      8, 4.015686274509804, 128, 2.3177407415254274),
    "(256,8)-Suboptimal": ("50a1ab58ce4ac606afa77dc0adf82e93b6f8bd221f5e06190f571da155f6c64f",
                           4, 2.8147671568627453, 278, 0.6526307364406781),
}
# Fig 10's eight workloads (benchmarks/fig10_large_sim.py) and their values
# on (256,8)-Suboptimal, from the JAX package on a CPU
FIG10 = (
    ("alltoall-64KB", "collective", {"op": "alltoall", "unit_bytes": 64 << 10}, 0.6526307364406781),
    ("alltoall-512KB", "collective", {"op": "alltoall", "unit_bytes": 512 << 10}, 4.174913041525425),
    ("beff", "beff", {"n_sizes": 5, "n_random": 2}, 6527098662.817301),
    ("ffte", "ffte", {"array_len": 1 << 21}, 0.46024219473220374),
    ("g500-bfs", "graph500", {"scale": 12}, 1.3811703775661024),
    ("npb-is-S", "npb", {"kernel": "is", "klass": "S"}, 1.5433043817627126),
    ("npb-is-A", "npb", {"kernel": "is", "klass": "A"}, 1.583323684542374),
    ("npb-ft-A", "npb", {"kernel": "ft", "klass": "A"}, 3.3102480435254256),
)
# Table 5/6's dragonflies (paper_suite("large-dragonfly")): degree 11, the
# sweep's "global" instantiation; n, total hops, diameter
LARGE_DRAGONFLY = {"(252,11)-Dragonfly": (252, 171332, 3),
                   "(264,11)-Dragonfly": (264, 186516, 3)}
REL = 1e-9  # float values across numpy builds; integers and edges are exact


def _edges_sha(g) -> str:
    import hashlib

    return hashlib.sha256(json.dumps([[int(u), int(v)] for u, v in g.edges])
                          .encode()).hexdigest()


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= REL * abs(want)


class _FirstShapes:
    """Wraps ``bfs_sweep.sweep`` and ``bfs_sweep.patch_apply`` while phase 21
    runs: each wrapper keeps a copy of the inputs of the first call at every
    shape and calls the wrapped function.  The wrapped function counts its
    launches through its module-level name, which is the wrapper while this
    is installed: ``uninstall`` adds those counts back."""

    def __init__(self):
        from collections import Counter

        from repro_torch.kernels import bfs_sweep as bs

        self.bs = bs
        self.orig = {"sweep": bs.sweep, "patch_apply": bs.patch_apply}
        self.first = {"sweep": {}, "patch_apply": {}}
        for name, fn in self.orig.items():
            def wrapper(*args, _name=name, _fn=fn):
                key = self._key(_name, args)
                if key not in self.first[_name]:
                    self.first[_name][key] = tuple(
                        a.clone() if hasattr(a, "clone") else a for a in args)
                return _fn(*args)

            wrapper.launches, wrapper.shapes = 0, Counter()
            setattr(bs, name, wrapper)

    @staticmethod
    def _key(name, args):
        if name == "sweep":  # (b, sw_pad, n, kmax)
            nb, _, F0, _ = args
            return (nb.shape[0], F0.shape[2], nb.shape[1], nb.shape[2])
        dist, _, crows = args  # (b, mmax, s, n)
        return (dist.shape[0], crows.shape[1], dist.shape[1], dist.shape[2])

    def uninstall(self) -> None:
        for name, fn in self.orig.items():
            wrapper = getattr(self.bs, name)
            fn.launches += wrapper.launches
            fn.shapes.update(wrapper.shapes)
            setattr(self.bs, name, fn)


def _time_sweep(bs, label: str, nb, vm, F0, sentinel: int) -> dict:
    """One sweep shape: bit-exact against its plain version on the card,
    then timed (CUDA events) beside its plain version and its bound."""
    import torch

    got = bs.sweep(nb, vm, F0, sentinel)
    want = bs.sweep_rows_ref(nb, vm, F0, sentinel)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"bfs_sweep_kernel != sweep_rows_ref ({label})")
    ms = cuda_ms(lambda: bs.sweep(nb, vm, F0, sentinel))
    plain_ms = cuda_ms(lambda: bs.sweep_rows_ref(nb, vm, F0, sentinel), reps=3, n=1)
    b, n, kmax = nb.shape
    sw = F0.shape[2]
    levels = [int(got[g][got[g] < sentinel].max()) + 1
              if bool((got[g] < sentinel).any()) else 0 for g in range(b)]
    nbytes = (nb.numel() + vm.numel() + F0.numel() + got.numel()) * 4
    nops = sum(lv * n * kmax * sw * 2 for lv in levels)  # AND + OR per gather
    bms, by, terms = bound(nbytes, [(nops, INT32_OPS_PER_S)])
    plan = bs.sweep_plan(n, kmax)
    log(f"    sweep {label}: b={b} n={n} kmax={kmax} sw_pad={sw} ({plan.graph} graph, "
        f"{plan.threads} threads), levels {max(levels)}: bit-exact; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bms:.5f} ms ({terms})")
    return {"ms": ms, "bound_ms": bms}


def _time_patch(bs, label: str, dist, tmp, crows) -> dict:
    """One patch shape: bit-exact against its plain version on the card,
    then timed beside its plain version and its bound."""
    import torch

    got = bs.patch_apply(dist, tmp, crows)
    want = bs.patch_apply_ref(dist, tmp, crows)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"minplus_patch_kernel != patch_apply_ref ({label})")
    ms = cuda_ms(lambda: bs.patch_apply(dist, tmp, crows))
    plain_ms = cuda_ms(lambda: bs.patch_apply_ref(dist, tmp, crows), reps=3, n=1)
    b, s, n = dist.shape
    mmax = crows.shape[1]
    nbytes = (2 * dist.numel() + tmp.numel() + crows.numel()) * 4
    bms, by, terms = bound(nbytes, [(2 * b * s * n * mmax, INT32_OPS_PER_S)])
    plan = bs.patch_plan(b, s, n, mmax, all(t.data_ptr() % 16 == 0 for t in (dist, tmp, crows)))
    log(f"    patch {label}: b, s, n = {b}, {s}, {n} mmax={mmax} ({plan.kind}): bit-exact; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bms:.5f} ms ({terms})")
    return {"ms": ms, "bound_ms": bms}


def phase_suite256() -> dict:
    """Table 4 and Fig 10 of the paper through ``repro_torch.api`` on the
    card: ``run_experiment(paper_suite("256"), [stats, alltoall-64KB])``
    (the four searched graphs built through both BFS kernels, ``stats``
    through ``apsp`` on the card), every graph, integer and time held to the
    JAX package's; Fig 10's eight workloads on (256,8)-Suboptimal; the
    degree-11 dragonflies of Tables 5/6 through ``apsp`` on the card.  Then
    the first call of every kernel shape the phase launched, held against
    its plain version and timed, and Table 1's sweep shapes timed.  Returns
    both BFS kernels' launches and the (256,8)-Suboptimal graph."""
    import torch

    from repro_torch import api
    from repro_torch.core import graphs, metrics

    log('[21] the paper\'s 256-node suite: run_experiment(paper_suite("256"), '
        '[stats, alltoall-64KB]) on the card')
    t_phase = time.perf_counter()
    build_s = {}
    orig_build = api.build_topology

    def timed_build(spec, **kw):
        t = time.perf_counter()
        g = orig_build(spec, **kw)
        build_s[spec] = time.perf_counter() - t
        return g

    spent = {"evaluate_swap": 0.0, "evals": 0}
    orig_eval = metrics.SymmetricAPSP.evaluate_swap

    def timed_eval(ev, *a):
        t = time.perf_counter()
        out = orig_eval(ev, *a)
        spent["evaluate_swap"] += time.perf_counter() - t
        spent["evals"] += 1
        return out

    suite = api.paper_suite("256")
    workloads = [("stats", {"bw_restarts": 8}),
                 ("alltoall-64KB", "collective", {"op": "alltoall", "unit_bytes": 65536})]
    _reset_search_counts()
    shapes_seen = _FirstShapes()
    api.build_topology = timed_build
    metrics.SymmetricAPSP.evaluate_swap = timed_eval
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp = api.run_experiment(suite, workloads, device=DEV, parallel=False)
        torch.cuda.synchronize()
        t_exp = time.perf_counter() - t0
        # Tables 5/6's dragonflies: degree 11, the sweep's global instantiation
        dfly = api.paper_suite("large-dragonfly")
        dfly_d = {}
        t0 = time.perf_counter()
        for name in LARGE_DRAGONFLY:
            g = api.build_topology(dfly[name], device=DEV)
            dfly_d[name] = (g, metrics.apsp(g, device=DEV))
        t_dfly = time.perf_counter() - t0
    finally:
        api.build_topology = orig_build
        metrics.SymmetricAPSP.evaluate_swap = orig_eval
        shapes_seen.uninstall()
    launches, shapes, patch_shapes = _search_counts()
    t_builds = sum(build_s.values())
    log(f"    run_experiment {t_exp:.2f} s on the host clock: builds {t_builds:.2f} s, "
        f"cells {sum(sum(v.values()) for v in exp.seconds.values()):.2f} s; "
        f"SymmetricAPSP.evaluate_swap {spent['evaluate_swap']:.2f} s over "
        f"{spent['evals']} calls; launches {launches}")
    log(f"    bfs_sweep_kernel launches by (b, sw_pad): {shapes}")
    log(f"    minplus_patch_kernel launches by (b, mmax): {patch_shapes}")
    check(launches["bfs_sweep_kernel"] > 0 and launches["minplus_patch_kernel"] > 0,
          f"the 256-node suite did not launch both kernels: {launches}")

    for name in exp.names:
        g, st = exp.graphs[name], exp.values[name]["stats"]
        sha, diam, mpl, bw, a2a = SUITE256[name]
        got_a2a = exp.values[name]["alltoall-64KB"]
        log(f"    {name}: build {build_s[suite[name]]:.2f} s, stats "
            f"{exp.seconds[name]['stats']:.2f} s, alltoall {exp.seconds[name]['alltoall-64KB']:.2f} s "
            f"(host); D={st.diameter:.0f} MPL={st.mpl!r} BW={st.bw} alltoall-64KB "
            f"{got_a2a!r} s")
        check(g.n == 256 and _edges_sha(g) == sha, f"{name}: edges differ from the reference's")
        check((st.diameter, st.mpl, st.bw) == (diam, mpl, bw),
              f"{name}: D, MPL, BW {(st.diameter, st.mpl, st.bw)}, the reference's "
              f"{(diam, mpl, bw)}")
        check(_close(got_a2a, a2a), f"{name}: alltoall {got_a2a!r}, the reference's {a2a!r}")
    anchor = exp.values["(256,3)-Wagner"]["alltoall-64KB"] / \
        exp.values["(256,8)-Suboptimal"]["alltoall-64KB"]
    check(anchor >= 10.0, f"Fig 10 anchor: (256,8)-Suboptimal only {anchor:.2f}x Wagner")
    log(f"    Fig 10 anchor: (256,8)-Suboptimal {anchor:.2f}x faster than (256,3)-Wagner "
        f"on alltoall (>= 10); all ten graphs, D, MPL, BW equal the reference's, "
        f"alltoall within {REL}")

    g8 = exp.graphs["(256,8)-Suboptimal"]
    t0 = time.perf_counter()
    fig = api.run_experiment({"(256,8)-Suboptimal": g8},
                             [(key, wl, params) for key, wl, params, _ in FIG10],
                             device=DEV, parallel=False)
    t_fig = time.perf_counter() - t0
    for key, _, _, want in FIG10:
        got = fig.values["(256,8)-Suboptimal"][key]
        check(_close(got, want), f"Fig 10 {key}: {got!r}, the reference's {want!r}")
    log(f"    Fig 10's eight workloads on (256,8)-Suboptimal in {t_fig:.2f} s (host): "
        + ", ".join(f"{k} {fig.values['(256,8)-Suboptimal'][k]!r}" for k, *_ in FIG10)
        + f"; each within {REL} of the reference's")

    for name, (n, total, diam) in LARGE_DRAGONFLY.items():
        g, d = dfly_d[name]
        check(np.array_equal(d, metrics.apsp(g, device="cpu")),
              f"{name}: apsp on the card differs from its plain version")
        got = (g.n, int(d[~np.eye(g.n, dtype=bool)].sum()), int(d.max()))
        check(got == (n, total, diam) and g.degree() == 11,
              f"{name}: (n, total, diameter) {got}, pinned {(n, total, diam)}")
    bs = shapes_seen.bs
    log(f"    {', '.join(LARGE_DRAGONFLY)}: apsp on the card == plain == pinned totals and "
        f"diameters; sweep plan {bs.sweep_plan(252, 11).graph} at kmax 11; "
        f"{t_dfly:.2f} s (host)")

    # the first call at every shape the phase launched: bit-exact, timed
    rows = {"sweep": {}, "patch_apply": {}}
    for key, args in sorted(shapes_seen.first["sweep"].items()):
        rows["sweep"][key] = _time_sweep(bs, f"{key[:2]} first call (n={key[2]}, kmax={key[3]})",
                                         *args)
    for key, args in sorted(shapes_seen.first["patch_apply"].items()):
        rows["patch_apply"][key] = _time_patch(bs, f"{key[:2]} first call", *args)
    # Table 1's shapes (phase 19: one sweep of every source of each golden
    # graph, n <= 36), timed here
    dev = torch.device(DEV)
    timed_t1 = set()
    for name, fn, args, n, k, *_ in GOLDEN:
        g = getattr(graphs, fn)(*args)
        nb, vm, F0, sw_pad, _ = bs.pack_batch(metrics._nbr_table(g.adjacency())[None],
                                              np.arange(n))
        if (n, nb.shape[2], sw_pad) in timed_t1:
            continue
        timed_t1.add((n, nb.shape[2], sw_pad))
        _time_sweep(bs, f"Table 1 {name}", *(bs.as_words(a, dev) for a in (nb, vm, F0)), n)
    log(f"    phase 21 {time.perf_counter() - t_phase:.1f} s in all")
    return launches, g8


# Step 4 of the paper's evidence (phase 22), as the JAX package computes it
# on a CPU: optimize_layout of (256,8)-Suboptimal under 16x16 mesh traffic
# (axis bytes 1, 8; seed 0, 20000 iterations): sha256 of the perm (JSON list),
# cost and identity cost
LAYOUT256 = ("3c5ce30fc002aaf75180a754689ecda6d11bcf736e087c4035bb267beacf5305",
             7974.0, 11632.0)
# plan_elastic_remesh (axis bytes 1, 8; seed 0, 4000 layout iterations):
# dead nodes, mesh shape, sha256 of the device order (JSON list), layout cost.
# The fleet row: the pinned (8192, 8) circulant with 64 nodes drawn dead by
# default_rng(0); the reference's own apsp (a dense matmul per BFS level)
# does not finish at this size, so its pin comes from the JAX package's
# plan_elastic_remesh, unchanged, over an equal distance matrix built from
# its apsp_hops.  The ring rows: two components (vertex 0's is kept) and an
# isolated survivor (11).
REMESH_FLEET = ((64, 64), "961f36819915fa2f2fa2a4dc4d647472e8935c631ce2f2a0a8058d7323abd8a7",
                433028.0)
REMESH_RING256 = (
    ((0, 128), (8, 8), "5d2483ff4d4ffc3236188e0a882e3f07bc900288ff9aa7629a0d89b5d8bb46f0",
     9796.0),
    ((10, 12), (16, 8), "b55cb55dd3ec12d4f8fb83d3729b5063be5504360a6ef68669f1811eef680a1e",
     47012.0),
)


def _ints_sha(values) -> str:
    import hashlib

    return hashlib.sha256(json.dumps([int(v) for v in values]).encode()).hexdigest()


def phase_layout_remesh(g8) -> dict:
    """The paper's step 4 on the card: ``optimize_layout`` of phase 21's
    (256,8)-Suboptimal graph and ``plan_elastic_remesh`` of the pinned
    (8192, 8) circulant after 64 failures, their ``apsp`` on the card (the
    survivors' sweep held bit-exact against its plain version and timed, the
    copy home apart), each plan equal to the JAX package's; a fleet-size
    survivor graph with an isolated vertex through ``apsp`` (sentinel
    rows); the disconnected fallbacks on ``ring(256)``.  Returns both BFS
    kernels' launches."""
    import torch

    from repro_torch.core import graphs, layout, metrics
    from repro_torch.core.known_optimal import KNOWN_CIRCULANT_OFFSETS
    from repro_torch.runtime import plan_elastic_remesh, surviving_subgraph

    log("[22] the paper's step 4: optimize_layout and plan_elastic_remesh, apsp on the card")
    t_phase = time.perf_counter()
    _reset_search_counts()
    t0 = time.perf_counter()
    res = layout.optimize_layout(g8, layout.mesh_traffic((16, 16), (1.0, 8.0)), seed=0,
                                 device=DEV)
    t_layout = time.perf_counter() - t0
    got = (_ints_sha(res.perm), res.cost, res.identity_cost)
    check(got == LAYOUT256, f"optimize_layout of {g8.name}: {got}, the reference's {LAYOUT256}")
    log(f"    optimize_layout({g8.name}, 16x16 mesh, seed 0, {res.iterations} iterations): "
        f"cost {float(res.cost)!r} from {float(res.identity_cost)!r}, improvement "
        f"{res.improvement:.4f}, {t_layout:.2f} s (host; one apsp on the card); perm and "
        f"costs equal the reference's")

    n = 8192
    g = graphs.circulant(n, KNOWN_CIRCULANT_OFFSETS[(n, 8)])
    dead = sorted(np.random.default_rng(0).choice(n, 64, replace=False).tolist())
    spent = {"apsp": 0.0, "calls": 0}
    orig_apsp = metrics.apsp

    def timed_apsp(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_apsp(*a, **kw)
        spent["apsp"] += time.perf_counter() - t
        spent["calls"] += 1
        return out

    shapes_seen = _FirstShapes()
    metrics.apsp = timed_apsp
    try:
        t0 = time.perf_counter()
        plan = plan_elastic_remesh(g, dead, axis_bytes=(1.0, 8.0), layout_iters=4000,
                                   device=DEV)
        t_plan = time.perf_counter() - t0
        metrics.apsp = orig_apsp
        got = (plan.mesh_shape, _ints_sha(plan.device_order), plan.layout_cost)
        check(got == REMESH_FLEET and plan.dropped == dead and plan.connected,
              f"plan_elastic_remesh at {n}: {got}, the reference's {REMESH_FLEET}")
        log(f"    plan_elastic_remesh(circulant({n}, 8), 64 dead, 4000 iterations): mesh "
            f"{plan.mesh_shape}, layout cost {float(plan.layout_cost)!r}, improvement "
            f"{plan.layout_improvement:.4f}; {t_plan:.2f} s (host clock), {spent['apsp']:.2f} "
            f"s of it in {spent['calls']} apsp calls on the card; plan equals the reference's")

        # an isolated survivor at fleet size: an all-pad table row, sentinel rows
        iso = 100
        sub, _ = surviving_subgraph(g, sorted(np.nonzero(g.adjacency()[iso])[0].tolist()))
        d = metrics.apsp(sub, device=DEV)
        check(np.array_equal(d, metrics.apsp(sub, device="cpu")),
              "apsp of the isolated-survivor graph differs from its plain version")
        check(int(np.isinf(d).sum()) == 2 * (sub.n - 1) and not metrics.is_connected(sub, d),
              "the isolated survivor is not unreachable")
        log(f"    apsp of circulant({n}, 8) minus vertex {iso}'s 8 neighbours (n={sub.n}, "
            f"one all-pad row) on the card == plain; {2 * (sub.n - 1)} unreachable pairs")

        for dead_ring, shape, sha, cost in REMESH_RING256:
            t0 = time.perf_counter()
            plan = plan_elastic_remesh(graphs.ring(256), list(dead_ring), device=DEV)
            got = (plan.mesh_shape, _ints_sha(plan.device_order), plan.layout_cost)
            check(got == (shape, sha, cost),
                  f"plan_elastic_remesh(ring(256), {dead_ring}): {got}, the reference's")
            log(f"    plan_elastic_remesh(ring(256), dead {list(dead_ring)}): vertex 0's "
                f"component, mesh {plan.mesh_shape}, cost {float(plan.layout_cost)!r}, "
                f"{len(plan.dropped)} dropped, {time.perf_counter() - t0:.2f} s; equal to "
                f"the reference's")
    finally:
        metrics.apsp = orig_apsp
        shapes_seen.uninstall()
    # the timing below launches outside the path: count the path up to here
    launches, shapes, _ = _search_counts()
    bs = shapes_seen.bs
    for key, args in sorted(shapes_seen.first["sweep"].items()):
        _time_sweep(bs, f"{key[:2]} first call (n={key[2]}, kmax={key[3]})", *args)
        if key[2] < 8000:
            continue
        out = bs.sweep(*args)
        copies = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.cpu()
            copies.append((time.perf_counter() - t0) * 1e3)
        log(f"    copy home of {out.numel() * 4} B {float(np.median(copies)):.2f} ms "
            f"(host clock, median of 3)")
    log(f"    bfs_sweep_kernel launches by (b, sw_pad): {shapes}; "
        f"phase 22 {time.perf_counter() - t_phase:.1f} s in all")
    check(launches["bfs_sweep_kernel"] > 0, f"phase 22 launched no sweep: {launches}")
    return launches


# phase 23's gloo payload: PyTorch DDP's default bucket, 25 MiB of float32
GLOO_RANKS = 8
GLOO_FLOATS = 25 * 2 ** 20 // 4
GLOO_CHECKS = ("ring", "recursive_doubling", "ring_hamiltonian", "int8_ring", "flood_root0",
               "flood_root5")


def _gloo_collectives(seed, group=None):
    """One rank of phase 23's gloo group: every rank draws the same
    (ranks, GLOO_FLOATS) payload from ``seed`` and takes its own row; each
    collective is timed between barriers and held against the plain sum (or
    the root's row).  Returns errors then seconds, one per ``GLOO_CHECKS``."""
    import functools

    import torch
    import torch.distributed as dist

    from repro_torch.comm import torchcoll as tc
    from repro_torch.core import graphs
    from repro_torch.core.hamiltonian import hamiltonian_cycle

    rank = dist.get_rank(group)
    full = np.random.default_rng(int(seed)).standard_normal((GLOO_RANKS, GLOO_FLOATS),
                                                            dtype=np.float32)
    x = torch.from_numpy(full[rank].copy())
    want = full.sum(0, dtype=np.float64)
    order = hamiltonian_cycle(graphs.torus([2, 4]))
    calls = (functools.partial(tc.ring_allreduce),
             functools.partial(tc.recursive_doubling_allreduce),
             functools.partial(tc.ring_allreduce, order=order),
             functools.partial(tc.int8_ring_allreduce),
             functools.partial(tc.flood_bcast, g=graphs.wagner(8), root=0),
             functools.partial(tc.flood_bcast, g=graphs.wagner(8), root=5))
    errs, secs = [], []
    for name, fn in zip(GLOO_CHECKS, calls):
        dist.barrier(group)
        t0 = time.perf_counter()
        out = fn(x, group)
        dist.barrier(group)
        secs.append(time.perf_counter() - t0)
        assert out.device == x.device and out.dtype == x.dtype, name
        got = out.numpy().astype(np.float64)
        if name.startswith("flood"):
            errs.append(float(np.abs(got - full[int(name[-1])]).max()))
        elif name == "int8_ring":
            errs.append(float(np.abs(got - want).max() / np.abs(want).max()))
        else:
            errs.append(float(np.abs(got - want).max()))
    return torch.tensor(errs + secs, dtype=torch.float64)


# phase 23's NCCL rank at world size 1: each collective on a 25 MiB float32
# CUDA tensor (and ring_allreduce on a 0-d one)
NCCL_CASES = ("ring_allreduce", "ring_allreduce 0-d", "ring_reduce_scatter", "ring_allgather",
              "recursive_doubling_allreduce", "int8_ring_allreduce", "flood_bcast")
NCCL_MS = [0.0]  # the NCCL rank's milliseconds in its calls, read by main


def _nccl_world_one(seed, group=None):
    """Phase 23's one NCCL rank, which ``run_on_axis(..., backend="nccl")``
    puts on CUDA device 0: every ``NCCL_CASES`` call on CUDA tensors drawn
    from ``seed``, timed on the host clock between synchronizations; then a
    gloo group of the same world, handed the CUDA tensor.  Returns 1.0 for
    each call that returned its input exactly on the card and 1.0 if the
    gloo group refused the tensor, then each call's milliseconds."""
    import torch
    import torch.distributed as dist

    from repro_torch.comm import torchcoll as tc
    from repro_torch.core import graphs

    gen = torch.Generator(device=seed.device).manual_seed(int(seed))
    x = torch.randn(GLOO_FLOATS, device=seed.device, generator=gen)
    x0 = torch.randn((), device=seed.device, generator=gen)
    one = graphs.from_edges(1, [], "one")
    calls = ((lambda: tc.ring_allreduce(x, group), x),
             (lambda: tc.ring_allreduce(x0, group), x0),
             (lambda: tc.ring_reduce_scatter(x, group), x),
             (lambda: tc.ring_allgather(x, group), x),
             (lambda: tc.recursive_doubling_allreduce(x, group), x),
             (lambda: tc.int8_ring_allreduce(x, group), x),
             (lambda: tc.flood_bcast(x, group, g=one), x))
    same, ms = [], []
    for fn, want in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        same.append(float(out.device == want.device and torch.equal(out, want)))
    # gloo moves host memory: a CUDA tensor is refused, not moved
    gloo = dist.new_group(backend="gloo")
    try:
        tc.ring_allreduce(x, group=gloo)
        same.append(0.0)
    except ValueError:
        same.append(1.0)
    return torch.tensor(same + ms, dtype=torch.float64)


def phase_collectives() -> dict:
    """The Hamiltonian-ring collectives (``repro_torch.comm.torchcoll``):
    every function on CUDA tensors over NCCL at world size 1, through
    ``run_on_axis(..., backend="nccl")`` (one GPU, and NCCL holds one rank a
    device: each returns its input, moving no bytes), then an 8-rank gloo
    group on the host with a 25 MiB float32 payload a rank, each call timed
    and held to the plain sum; the schedules' round counts against the
    eccentricity from ``apsp`` on the card.  Returns both BFS kernels'
    launches."""
    from repro_torch.comm import torchcoll as tc
    from repro_torch.core import collectives as C
    from repro_torch.core import graphs, metrics

    log("[23] the collectives: NCCL at world size 1 on the card, 8 gloo ranks on the host")
    t_phase = time.perf_counter()
    _reset_search_counts()
    t0 = time.perf_counter()
    res = tc.run_on_axis(_nccl_world_one, 1, np.full(1, 23), backend="nccl").numpy()[0]
    t_nccl = time.perf_counter() - t0
    same, ms = res[:len(NCCL_CASES) + 1], res[len(NCCL_CASES) + 1:]
    NCCL_MS[:] = [float(ms.sum())]
    for name, good in zip(NCCL_CASES, same):
        check(good == 1.0, f"{name} at NCCL world size 1 does not return its input on the card")
    check(same[-1] == 1.0, "a gloo group took a CUDA tensor")
    log(f"    NCCL world size 1 through run_on_axis ({t_nccl:.1f} s with the spawn), "
        f"{GLOO_FLOATS * 4} B CUDA tensors, each returned exactly on the card: "
        + ", ".join(f"{name} {t:.3f} ms" for name, t in zip(NCCL_CASES, ms))
        + "; a gloo group refuses the CUDA tensor")

    t0 = time.perf_counter()
    res = tc.run_on_axis(_gloo_collectives, GLOO_RANKS, np.full(GLOO_RANKS, 23)).numpy()
    t_group = time.perf_counter() - t0
    errs, secs = res[:, :len(GLOO_CHECKS)].max(0), res[:, len(GLOO_CHECKS):].max(0)
    limits = (1e-5, 1e-5, 1e-5, 0.05, 0.0, 0.0)
    for name, err, sec, lim in zip(GLOO_CHECKS, errs, secs, limits):
        check(err <= lim, f"gloo {name}: error {err!r} above {lim}")
    log(f"    {GLOO_RANKS} gloo ranks, {GLOO_FLOATS * 4} B float32 a rank ({t_group:.1f} s "
        f"with the spawn): " + ", ".join(f"{name} {sec:.3f} s (error {err:.3g} <= {lim})"
                                         for name, err, sec, lim
                                         in zip(GLOO_CHECKS, errs, secs, limits)))
    g = graphs.wagner(8)
    rounds = (len(C.bcast_flood(8, 1.0, g, root=0).rounds),
              int(metrics.eccentricities(g, device=DEV)[0]),
              len(C.allreduce_ring(8, 1024.0).rounds))
    check(rounds[0] == rounds[1] and rounds[2] == 2 * (8 - 1),
          f"round counts {rounds}: flood rounds != eccentricity or ring != 14")
    log(f"    round counts: wagner(8) flood {rounds[0]} == eccentricity of root 0; ring "
        f"allreduce {rounds[2]} == 2(n-1); phase 23 {time.perf_counter() - t_phase:.1f} s")
    return _search_counts()[0]


# phase 24: the JAX package's table and figure modules on a CPU
# (benchmarks/table1_graph_properties.py, fig4_collectives.py, fig_routing.py,
# table2_3_dragonfly.py, table5_6_large_dragonfly.py): rows, sha256 of the
# JSON list of [name, derived] pairs; the fsum of fig4's values and of
# fig_routing's static and adaptive seconds (Tables 2/3 and 5/6 carry every
# value in their derived strings, their row numbers are host seconds or 0)
SCRIPT_ROWS = {
    "table1": (13, "42f1cf9d9dc0730c7f738003491925317cad3623f9bb6bba3ddc6c2b3134f050", None),
    "fig4": (208, "ebdd9be5de2c5c96a9519aa226ae8a07949375dbbdd06825f023ea0735584509",
             736.005724615572),
    "fig_routing": (17, "c47b93df2686ef348d1fe8bcb99c58ce9740639f662af3055cf63598e7656575",
                    3.3456889995654673),
    "table2_3": (18, "25600cf23d3f0d7a3d0b6d8f8fbca4f9819ea569db2d718134931cb16d3960fe", None),
    "table5_6": (10, "cb4a2fc75c24fee4d00e74eb594040f61dcd92110a214bb2c42ada7de9292acd", None),
}


def phase_paper_scripts() -> dict:
    """The paper's table and figure modules over ``repro_torch.api`` on the card:
    ``benchmarks/torch_run.py --only table1,fig4,fig_routing,table2_3,table5_6``,
    each module's rows equal to the JAX package's, Table 1 equal to the
    paper's D, MPL and BW.  Returns both BFS kernels' launches."""
    import contextlib
    import hashlib
    import io
    import math

    from benchmarks import torch_run

    only = ",".join(SCRIPT_ROWS)
    log(f"[24] the paper's table and figure modules: benchmarks/torch_run.py --only {only} "
        "on the card")
    _reset_search_counts()
    csv = io.StringIO()
    with contextlib.redirect_stdout(csv):
        out = torch_run.main(["--only", only])
    launches, shapes, _ = _search_counts()
    for key, (count, sha, total) in SCRIPT_ROWS.items():
        rows, secs = out[key]
        got = hashlib.sha256(json.dumps([[n, d] for n, _, d in rows.rows])
                             .encode()).hexdigest()
        check(len(rows.rows) == count and got == sha,
              f"{key}: {len(rows.rows)} rows, sha {got}; the reference's {count}, {sha}")
        fsum = None
        if key == "fig4":
            fsum = math.fsum(r["seconds"] for r in rows.results)
        elif key == "fig_routing":
            fsum = math.fsum(r["static_s"] + r["adaptive_s"] for r in rows.results)
            check(next(r for r in rows.results if r["key"] == "torus_alltoall")
                  ["adaptive_vs_static"] > 1, "fig_routing: adaptive does not beat static")
        elif key == "table1":
            check(all("match=Y" in d for _, _, d in rows.rows),
                  "table1: a row differs from the paper's D, MPL or BW")
        check(fsum is None or _close(fsum, total), f"{key}: values sum {fsum!r}, "
              f"the reference's {total!r}")
        log(f"    {key}: {len(rows.rows)} rows in {secs:.2f} s (host clock), names and "
            f"derived strings equal the reference's"
            + ("; every D, MPL, BW equal the paper's" if key == "table1" else
               f"; values sum {fsum!r} within {REL}" if fsum is not None else ""))
    log(f"    {len(csv.getvalue().splitlines())} CSV lines under results/torch_benchmarks/; "
        f"bfs_sweep_kernel launches by (b, sw_pad): {shapes}")
    check(launches["bfs_sweep_kernel"] > 0, f"the modules' stats launched no sweep: {launches}")
    return launches


def phase_symmetric_pinned(n: int = 8192, k: int = 8, fold: int = 8, n_iter: int = 6) -> None:
    """The reference benchmark's ``polish_n8192_k8_pallas`` spec on the card."""
    import torch

    from repro_torch.core.known_optimal import KNOWN_CIRCULANT_OFFSETS
    from repro_torch.core.search import _circulant_profile, symmetric_sa_search

    offs = KNOWN_CIRCULANT_OFFSETS[(n, k)]
    _reset_search_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = symmetric_sa_search(n, k, seed=0, n_iter=n_iter, fold=fold, start_offsets=offs,
                              device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes, patch_shapes = _search_counts()
    log(f"[8] symmetric_sa_search({n}, {k}, seed=0, n_iter={n_iter}, fold={fold}, "
        f"start_offsets={offs}) on {DEV}: wall {wall:.2f} s; mpl={float(res.mpl)!r} "
        f"diameter={res.diameter} accepted={res.accepted} evals_delta={res.evals_delta} "
        f"evals_full={res.evals_full}; launches {launches}, by (b, sw_pad) {shapes}, "
        f"by (b, mmax) {patch_shapes}")
    check(res.evals_delta + res.evals_full > 0, "no proposal was priced")
    recheck(res, n, k, fold, _circulant_profile(n, offs)[0])


def phase_symmetric_card_vs_cpu() -> None:
    """replicas=1 on the card and on the CPU: every field equal."""
    import torch

    from repro_torch.core import metrics
    from repro_torch.core.graphs import circulant
    from repro_torch.core.known_optimal import KNOWN_CIRCULANT_OFFSETS
    from repro_torch.core.search import (_circulant_orbits, _draw_orbit_swap, large_search,
                                         symmetric_sa_search)

    cases = [
        ("large_search(2048, 6, seed=0, fold=4, polish_iters=40)",
         lambda dev: large_search(2048, 6, seed=0, fold=4, polish_iters=40, device=dev)),
        ("symmetric_sa_search(64, 6, seed=0, n_iter=800, fold=4, compound moves)",
         lambda dev: symmetric_sa_search(64, 6, seed=0, n_iter=800, fold=4, t_start=1e-6,
                                         t_end=1e-9, start_offsets=(1, 9, 23),
                                         moves_per_step=3, device=dev)),
    ]
    for label, fn in cases:
        _reset_search_counts()
        t0 = time.perf_counter()
        a = fn(DEV)
        t_gpu = time.perf_counter() - t0
        patch_shapes = _search_counts()[2]
        t0 = time.perf_counter()
        b = fn("cpu")
        t_cpu = time.perf_counter() - t0
        check(_fields(a) + (a.compound_steps,) == _fields(b) + (b.compound_steps,),
              f"card and CPU paths differ: {label}")
        log(f"[9] {label}: card == CPU in every field (mpl={float(a.mpl)!r}, "
            f"accepted={a.accepted}, evals_delta={a.evals_delta}, evals_full={a.evals_full}, "
            f"compound_steps={a.compound_steps}); cuda {t_gpu:.2f} s, cpu {t_cpu:.2f} s; "
            f"minplus_patch_kernel launches by (b, mmax) {patch_shapes}")
        if "compound" in label:
            check(a.compound_steps > 0, "no compound step was priced")

    # one compound proposal at (2048, 6), fold 4, as symmetric_sa_search
    # merges it: three 2-orbit moves, 24 added edges with 48 endpoints, so
    # mmax 64, beyond the stream templates: the tile instantiation at b = 1
    n, k, fold = 2048, 6, 4
    s = n // fold
    orbits = sorted(_circulant_orbits(n, s, KNOWN_CIRCULANT_OFFSETS[(n, k)]), key=sorted)
    chords = {e for orb in orbits for e in orb}
    ring = {(i, (i + 1) % n) for i in range(n - 1)} | {(0, n - 1)}
    rng = np.random.default_rng(0)
    work_list, work_chords, moves = orbits, chords, 0
    while moves < 3:
        mv = _draw_orbit_swap(rng, work_list, work_chords, ring, n, s, fold)
        if mv is None:
            continue
        i1, i2, no1, no2, new_edges, remaining = mv
        work_list = [o for i, o in enumerate(work_list) if i not in (i1, i2)] + [no1, no2]
        work_chords = remaining | new_edges
        moves += 1
    removed, added = sorted(chords - work_chords), sorted(work_chords - chords)
    adj = circulant(n, KNOWN_CIRCULANT_OFFSETS[(n, k)]).adjacency()
    toks = []
    for d in (DEV, "cpu"):
        _reset_search_counts()
        toks.append(metrics.SymmetricAPSP(adj.copy(), s, device=d).evaluate_swap(removed, added))
        if d == DEV:
            patch_shapes = _search_counts()[2]
    check(torch.equal(toks[0].dist.cpu(), toks[1].dist)
          and (toks[0].total, toks[0].diam) == (toks[1].total, toks[1].diam),
          "card and CPU tokens differ on the compound proposal")
    check((1, 64) in patch_shapes, f"the compound proposal's patch was not mmax 64: {patch_shapes}")
    log(f"[9] a compound proposal at ({n}, {k}), fold {fold} (three moves: {len(removed)} edges "
        f"out, {len(added)} in): card == CPU tokens (mpl={toks[0].mpl!r}); "
        f"minplus_patch_kernel launches by (b, mmax) {patch_shapes}")

    # a disconnecting orbit swap (the ring orbit of C_24(1, 8)) and its
    # recovery, which a disconnected base forces onto the full path
    n, s = 24, 6
    ring = sorted((min(i, (i + 1) % n), max(i, (i + 1) % n)) for i in range(n))
    evs = [metrics.SymmetricAPSP(circulant(n, [1, 8]).adjacency(), s, device=d)
           for d in (DEV, "cpu")]
    for removed, added in ((ring, []), ([], ring)):
        toks = [ev.evaluate_swap(removed, added) for ev in evs]
        check(torch.equal(toks[0].dist.cpu(), toks[1].dist)
              and (toks[0].total, toks[0].diam, toks[0].mpl)
              == (toks[1].total, toks[1].diam, toks[1].mpl),
              "card and CPU tokens differ on the disconnect-and-recover swaps")
        for ev, tok in zip(evs, toks):
            ev.commit(tok)
            ev.verify()
    check((evs[0].n_delta, evs[0].n_full) == (evs[1].n_delta, evs[1].n_full)
          and evs[0].connected, "card and CPU counters differ after the recovery")
    log(f"[9] SymmetricAPSP(C_24(1, 8)): the ring orbit removed (mpl inf) and restored, "
        f"card == CPU tokens, verify() passes, counters (delta, full) = "
        f"{(evs[0].n_delta, evs[0].n_full)}")


def phase_circulant(n: int = 8192, k: int = 8, seed: int = 1, n_iter: int = 400,
                    polish_iters: int = 100) -> None:
    """The batched circulant pricer on the card against the numpy pricer,
    then the default large-N call with no pinned offsets end to end."""
    import torch

    from repro_torch.core.search import circulant_search, large_search

    runs, walls = {}, {}
    for engine in ("torch", "numpy", "numpy", "torch"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = circulant_search(n, k, seed=seed, n_iter=n_iter, engine=engine, device=DEV)
        torch.cuda.synchronize()
        walls.setdefault(engine, []).append(time.perf_counter() - t0)
        runs[engine] = (r.graph.edges, r.offsets, r.history, r.iterations, r.accepted,
                        r.mpl, r.diameter)
    check(runs["torch"] == runs["numpy"], "torch and numpy circulant trajectories differ")
    warm = runs["torch"][5]
    log(f"[10] circulant_search({n}, {k}, seed={seed}, n_iter={n_iter}): torch pricer on "
        f"{DEV} == numpy pricer (offsets {runs['torch'][1]}, mpl={float(warm)!r}, "
        f"{len(runs['torch'][2])} history entries); torch {walls['torch']} s, "
        f"numpy {walls['numpy']} s")
    _reset_search_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = large_search(n, k, seed=seed, budget=n_iter, polish_iters=polish_iters, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, _, _ = _search_counts()
    log(f"[10] large_search({n}, {k}, seed={seed}, budget={n_iter}, polish_iters="
        f"{polish_iters}) on {DEV}: wall {wall:.2f} s; mpl={float(res.mpl)!r} "
        f"diameter={res.diameter} accepted={res.accepted} evals_delta={res.evals_delta} "
        f"evals_full={res.evals_full} offsets={res.offsets}; launches {launches}")
    check(launches["bfs_sweep_kernel"] > 0, "the polish did not launch the sweep")
    recheck(res, n, k, 4, warm)


def _attn_pairs(sq: int, skv: int, q_offset: int, causal: bool) -> int:
    """(query, key) pairs the attention computes: the causal part only."""
    if not causal:
        return sq * skv
    return sum(min(skv, q_offset + i + 1) for i in range(sq))


def phase_flash(serving=((4, 32, 32, 1024, 80), (4, 64, 8, 1024, 128))) -> dict:
    """flash_attention_kernel (bf16) and flash_attention_fp32_kernel against
    their plain version on the card, after a check of the wgmma fragment
    layouts the bf16 kernel rests on; then timed at each serving prefill's
    shape (b, h, kv, s, hd): zamba2-2.7b's and qwen3-32b's.  The kernels
    line takes the last (the dense prefill launches it most)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=DEV).manual_seed(1)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=DEV)

    # the fragment layouts: S = q k^T and bf16(S) v from the kernel's own
    # loads, descriptors and products, each register written where the
    # kernel takes it to lie; the products are exact, so only the order of
    # the fp32 sums differs (1e-5 of the largest value; a misplaced register
    # is off by the values themselves)
    for hd_ in (16, 24, 80, 128):
        q, k, v = (rnd(r, hd_).to(torch.bfloat16) for r in (64, 128, 128))
        s_k, o_k = fa.wgmma_layout_probe(q, k, v)
        s_ref = q.float() @ k.float().T
        o_ref = s_k.bfloat16().float() @ v.float()
        torch.cuda.synchronize()
        err_s = float((s_k - s_ref).abs().max())
        err_o = float((o_k[:, :hd_] - o_ref).abs().max())
        tol_s = 1e-5 * float(s_ref.abs().max())
        tol_o = 1e-5 * float(o_ref.abs().max())
        check(err_s <= tol_s and err_o <= tol_o and not bool(o_k[:, hd_:].any()),
              f"wgmma fragment layout wrong at hd={hd_}: S {err_s} (tol {tol_s}), "
              f"O {err_o} (tol {tol_o})")
        log(f"[11] wgmma fragment layout hd={hd_}: S err {err_s:.3g} (tol {tol_s:.3g}), "
            f"bf16(S) V err {err_o:.3g} (tol {tol_o:.3g})")

    def qkv(b_, h_, kv_, sq, skv, hd_, dtype):
        mk = lambda *shape: rnd(*shape).to(dtype)
        return mk(b_, h_, sq, hd_), mk(b_, kv_, skv, hd_), mk(b_, kv_, skv, hd_)

    # bf16 output: the kernel and the plain version both sum in fp32, in
    # other orders, and the kernel rounds P to bf16 before P V, then both
    # round; allow a few bf16 ulps of |out| <= 4
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    errs = []
    f32, b16 = torch.float32, torch.bfloat16
    # the serving shapes; GQA with q_offset and ragged lengths; then the
    # head dims of the reference's kernel cases (64, 112, 128) and of the
    # reduced config (16), in fp32 and bf16, so every head-dim template the
    # model can reach is run; non-causal, a ragged 19-row tile and a
    # q_offset case whose keys end inside a 128-key tile; hd 128 with the
    # dense family's GQA 64/8 in fp32 (the card-vs-CPU phase's kernel)
    cases = [(b, h, kv, s, s, hd, 0, b16, True) for b, h, kv, s, hd in serving]
    h, hd = serving[0][1], serving[0][4]
    cases += [(2, h, 8, 200, 328, hd, 128, b16, True),
              (2, h, 8, 200, 328, hd, 128, f32, True),
              (1, h, 8, 200, 328, hd, 0, f32, False),
              (2, 4, 2, 128, 128, 64, 0, f32, True),
              (2, 6, 2, 128, 256, 112, 128, f32, False),
              (1, 8, 2, 128, 384, 128, 256, b16, True),
              (2, 4, 2, 19, 19, 16, 0, f32, True),
              (2, 4, 2, 128, 128, 16, 0, b16, True),
              (2, 4, 2, 128, 128, 64, 0, b16, True),
              (2, 6, 2, 128, 256, 112, 128, b16, False),
              (1, h, 8, 200, 328, hd, 0, b16, False),
              (2, 4, 2, 19, 19, hd, 0, b16, True),
              (1, 4, 4, 77, 205, hd, 128, b16, True),
              (1, 64, 8, 256, 256, 128, 0, f32, True)]
    for b_, h_, kv_, sq, skv, hd_, off, dtype, causal in cases:
        q, k, v = qkv(b_, h_, kv_, sq, skv, hd_, dtype)
        got = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off)
        want = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(err <= tol[dtype], f"flash_attention_kernel != plain: {err} > {tol[dtype]} "
              f"at b={b_} h={h_} kv={kv_} sq={sq} skv={skv} hd={hd_} q_offset={off} {dtype} "
              f"causal={causal}")
        errs.append(err)
        log(f"[11] flash b={b_} h={h_} kv={kv_} sq={sq} skv={skv} hd={hd_} q_offset={off} "
            f"{str(dtype)[6:]} causal={causal}: max abs err {err:.3g} (tol {tol[dtype]})")
        del q, k, v, got, want
    for b, h, kv, s, hd in serving:
        row = flash_timed(rnd, b, h, kv, s, hd)
    return {"name": "flash_attention_kernel", "route": "cuda", "source": FLASH_SOURCE,
            "replaces": "src/repro/kernels/flash_attention.py:38", "max_abs_err": max(errs),
            **row}


def flash_timed(rnd, b: int, h: int, kv: int, s: int, hd: int) -> dict:
    """The bf16 kernel, its plain version and SDPA (GQA by ``enable_gqa``)
    at one serving prefill's shape, on the main path's layout: (b, h, s, hd)
    views of (b, s, h, hd) tensors; the bound from its causal FLOPs and
    bytes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    q = rnd(b, s, h, hd).to(torch.bfloat16).transpose(1, 2)
    k, v = (rnd(b, s, kv, hd).to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), reps=3, n=1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=hd ** -0.5, enable_gqa=kv != h))
    flops = 4 * b * h * _attn_pairs(s, s, 0, True) * hd  # q k^T and p v
    nbytes = 2 * b * s * hd * (2 * h + 2 * kv)  # q, k, v read, o written, bf16
    bms, by, terms = bound(nbytes, [(flops, BF16_FLOP_PER_S)])
    log(f"    serving shape b={b} h={h} kv={kv} s={s} hd={hd}: kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
        f"scaled_dot_product_attention {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), "
        f"bound {bms:.4f} ms ({terms}; {flops / 1e9:.2f} GFLOP at "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16, {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def phase_ssd(serving=((320, 1024, 64, 64, 256), (320, 1024, 64, 128, 256))) -> dict:
    """ssd_intra_chunk_kernel (bf16) and ssd_intra_chunk_fp32_kernel against
    their plain version on the card, after a check of the wgmma fragment
    layouts the bf16 kernel rests on; then timed at each serving prefill's
    shape (b*h, s, p, n, chunk): zamba2-2.7b's (n = 64) and mamba2-2.7b's
    (n = 128, one stage of shared memory).  The kernels line takes the last
    (the SSM prefill launches it most)."""
    import torch

    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device=DEV).manual_seed(2)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=DEV)

    # the fragment layouts: S = C B^T, (hi + lo)(W) X and (hi + lo)(X w)^T B
    # from the kernel's own loads, descriptors and products, each register
    # written where the kernel takes it to lie; the products are exact, so
    # only the order of the fp32 sums differs (1e-5 of the largest value; a
    # misplaced register is off by the values themselves)
    def split(v):
        hi = v.bfloat16().float()
        return hi, (v - hi).bfloat16().float()

    for n_, p_ in ((64, 64), (64, 128), (16, 16), (128, 48)):
        C, B = (rnd(64, n_).to(torch.bfloat16) for _ in range(2))
        X = rnd(64, p_).to(torch.bfloat16)
        W, w = rnd(64, 64), torch.rand(64, generator=gen, device=DEV)
        got = ssd.ssd_wgmma_layout_probe(C, B, X, W, w)
        w_hi, w_lo = split(W)
        xw_hi, xw_lo = split(X.float() * w[:, None])
        want = (C.float() @ B.float().T, w_hi @ X.float() + w_lo @ X.float(),
                xw_hi.T @ B.float() + xw_lo.T @ B.float())
        torch.cuda.synchronize()
        errs = [float((g - r).abs().max()) for g, r in zip(got, want)]
        tols = [1e-5 * float(r.abs().max()) for r in want]
        check(all(e <= t for e, t in zip(errs, tols)),
              f"ssd wgmma fragment layout wrong at n={n_} p={p_}: S, W X, state errors "
              f"{errs} (tols {tols})")
        log(f"[12] ssd wgmma fragment layout n={n_} p={p_}: S err {errs[0]:.3g}, W X err "
            f"{errs[1]:.3g}, state err {errs[2]:.3g} (tols {', '.join(f'{t:.3g}' for t in tols)})")

    def inputs(bh_, s_, p_, n_, dtype):
        x = rnd(bh_, s_, p_).to(dtype)
        B = (0.5 * rnd(bh_, s_, n_)).to(dtype)
        C = (0.5 * rnd(bh_, s_, n_)).to(dtype)
        dt = torch.nn.functional.softplus(rnd(bh_, s_))  # as the model makes dt
        A = -torch.exp(0.5 * rnd(bh_, 1))
        return x, dt, A, B, C

    # the serving shapes; then the reference's kernel cases (p 8..64, n up to
    # 128, chunks of 16..256, so ragged 64-row tiles), the reduced config
    # (p 8, n 16, chunk 8), p = 128 (the largest column template), the bf16
    # kernel's smallest chunk, p and n, and a chunk of 512 (one stage of
    # shared memory, two TMA boxes per slab)
    cases = [(*shape, torch.bfloat16) for shape in serving]
    cases += [(8, 64, 8, 16, 16, torch.float32),
              (2, 96, 64, 128, 32, torch.float32), (8, 128, 8, 16, 32, torch.float32),
              (2, 256, 16, 32, 256, torch.float32), (8, 16, 8, 16, 8, torch.float32),
              (2, 256, 128, 64, 128, torch.bfloat16), (4, 192, 16, 16, 64, torch.bfloat16),
              (2, 1024, 64, 64, 512, torch.bfloat16)]
    errs = []
    for bh_, s_, p_, n_, chunk_, dtype in cases:
        args = inputs(bh_, s_, p_, n_, dtype)
        y, st = ssd.ssd_intra_chunk(*args, chunk_)
        y_p, st_p = ssd.ssd_intra_chunk_plain(*args, chunk_)
        torch.cuda.synchronize()
        # fp32, relative to the largest magnitude of each output: the chunk's
        # cumsum of log-decays reaches |cs| ~ 10^2 and is summed in another
        # order by the kernel's warp scan than by torch.cumsum, so exp(cs_i -
        # cs_j) differs by ~1e-5 relative; the products add less (bf16: the
        # weighted operand split into two bf16 terms keeps ~16 bits)
        err_y = float((y - y_p).abs().max())
        err_s = float((st - st_p).abs().max())
        tol_y = 1e-4 * float(y_p.abs().max())
        tol_s = 1e-4 * float(st_p.abs().max())
        check(err_y <= tol_y and err_s <= tol_s,
              f"ssd_intra_chunk_kernel != plain at bh={bh_} s={s_} p={p_} n={n_} "
              f"chunk={chunk_} {dtype}: y {err_y} (tol {tol_y}), states {err_s} "
              f"(tol {tol_s})")
        errs.append(max(err_y, err_s))
        log(f"[12] ssd bh={bh_} s={s_} p={p_} n={n_} chunk={chunk_} {str(dtype)[6:]}: max abs "
            f"err y {err_y:.3g} (tol {tol_y:.3g}), states {err_s:.3g} (tol {tol_s:.3g})")
    # a bf16 shape outside the kernel's domain raises (no other kernel takes it)
    try:
        ssd.ssd_intra_chunk(*inputs(2, 64, 64, 64, torch.bfloat16), 32)
    except ValueError as e:
        log(f"    bf16 chunk 32 refused: {e}")
    else:
        raise RuntimeError("check failed: a bf16 chunk of 32 was not refused")
    for bh, s, p, n, chunk in serving:
        row = ssd_timed(inputs(bh, s, p, n, torch.bfloat16), chunk)
    return {"name": "ssd_intra_chunk_kernel", "route": "cuda", "source": SSD_SOURCE,
            "replaces": "src/repro/kernels/ssd_scan.py:32", "max_abs_err": max(errs),
            **row, "library_ms": None}


def ssd_timed(args, chunk: int) -> dict:
    """The bf16 kernel and its plain version at one serving prefill's shape;
    the bound from its causal products and bytes."""
    from repro_torch.kernels import ssd_scan as ssd

    x, dt, A, B, C = args
    bh, s, p = x.shape
    n = B.shape[-1]
    ms = cuda_ms(lambda: ssd.ssd_intra_chunk(x, dt, A, B, C, chunk))
    plain_ms = cuda_ms(lambda: ssd.ssd_intra_chunk_plain(x, dt, A, B, C, chunk), reps=3,
                       n=1)
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2  # causal (i, j) pairs of a chunk
    cb = bh * nc * 2 * pairs * n  # C B^T
    weighted = bh * nc * (2 * pairs * p + 2 * chunk * p * n)  # (scores * L * dt) X, X^T (B w)
    # every product on the tensor cores: C B^T exact in bf16, the weighted
    # products twice (the weighted operand split into two bf16 terms)
    ops = [(cb + 2 * weighted, BF16_FLOP_PER_S)]
    nbytes = (bh * s * (p + 2 * n) * 2 + bh * s * 4 + bh * 4  # x, B, C, dt, A
              + bh * s * p * 4 + bh * nc * p * n * 4)  # y, states
    bms, by, terms = bound(nbytes, ops)
    fp32_terms = bound(nbytes, [(cb, BF16_FLOP_PER_S), (weighted, FP32_FLOP_PER_S)])[2]
    log(f"    serving shape bh={bh} s={s} p={p} n={n} chunk={chunk} "
        f"({ssd.bf16_smem_bytes(chunk, p, n)} B of shared memory a stage): kernel {ms:.4f} ms "
        f"({(cb + weighted) / ms / 1e9:.1f} TFLOP/s of the reference's "
        f"{(cb + weighted) / 1e9:.2f} GFLOP), plain {plain_ms:.3f} ms, bound {bms:.4f} ms "
        f"({terms}; {(cb + 2 * weighted) / 1e9:.2f} GFLOP at {BF16_FLOP_PER_S / 1e12:.0f} "
        f"TFLOP/s bf16, {nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; with the "
        f"weighted products at {FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s fp32, as the first design "
        f"ran them: {fp32_terms})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def _reset_model_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    fa.flash_attention_fwd.launches = ssd.ssd_intra_chunk.launches = 0


def _model_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    return {"flash_attention_kernel": fa.flash_attention_fwd.launches,
            "ssd_intra_chunk_kernel": ssd.ssd_intra_chunk.launches}


def launches_per_prefill(cfg) -> dict:
    """Model kernel launches one prefill makes: an attention per dense layer
    or per application of the hybrid's shared block, an SSD per Mamba2
    layer."""
    attn = {"dense": cfg.n_layers, "ssm": 0,
            "hybrid": cfg.n_layers // max(cfg.shared_attn_every, 1)}[cfg.family]
    return {"flash_attention_kernel": attn,
            "ssd_intra_chunk_kernel": 0 if cfg.family == "dense" else cfg.n_layers}


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if hasattr(t, "numel"))


def free_device() -> None:
    """Drop what earlier phases left in the caching allocator, so a model
    that needs most of the card finds it."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(arch: str, phase: int, slots: int = 4, requests: int = 8,
                prompt_len: int = 1024, max_new: int = 32, max_seq: int = 1088,
                activations_gib: float = 6.0) -> dict:
    """The serving path of ``arch`` at full width and depth, bf16: the
    kernels' launches, TTFT, decode latency, throughput and peak memory,
    which must stay within ``activations_gib`` of the weights and the
    caches; then a profile of one prefill and of 4 decode steps."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import DecodeParams, Request, ServingEngine

    free_device()
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)  # the CUDA device: no device argument
    params = model.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.parameters())
    weights = _tensor_bytes(params.parameters())
    log(f"[{phase}] {arch}: {n_params / 1e9:.3f} B parameters ({cfg.dtype}, "
        f"{weights / 2**30:.2f} GiB) made on {model.device} in "
        f"{time.perf_counter() - t0:.2f} s; peak while drawing them "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=prompt_len).astype(np.int32)
               for _ in range(requests)]
    # warm-up (cuBLAS handles, the kernel library): one prefill, one decode step
    logits, cache = model.prefill(params, {"tokens": np.stack(prompts[:slots])}, max_seq)
    model.decode_step(params, np.zeros((slots, 1), np.int32), cache)
    del logits, cache
    torch.cuda.synchronize()

    eng = ServingEngine(model, params, max_seq=max_seq, slots=slots,
                        decode=DecodeParams(temperature=0.0, max_new_tokens=max_new))
    finite = []
    prefill = eng.prefill_fn

    def checked_prefill(p, batch):
        out = prefill(p, batch)
        finite.append(bool(torch.isfinite(out[0][..., :cfg.vocab].float()).all()))
        return out

    eng.prefill_fn = checked_prefill
    done = []
    _reset_model_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in range(0, requests, slots):  # the launcher's waves
        for rid in range(w, min(w + slots, requests)):
            eng.submit(Request(rid=rid, prompt=prompts[rid], max_new_tokens=max_new))
        eng.lanes = [None] * slots
        eng.cache = None
        done += eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _model_counts()
    peak = torch.cuda.max_memory_allocated()
    caches = _tensor_bytes(eng.cache.values())
    st = eng.stats(done)
    waves = -(-requests // slots)
    want = {k: waves * v for k, v in launches_per_prefill(cfg).items()}
    check(launches == want, f"model kernel launches {launches}, expected {want}")
    check(len(done) == requests and all(len(r.out_tokens) == max_new for r in done),
          "not every request got its tokens")
    check(all(0 <= t < cfg.vocab for r in done for t in r.out_tokens),
          "a sampled token is outside the vocab")
    check(len(finite) == waves and all(finite), f"prefill logits not finite: {finite}")
    decode_ms = [(r.t_done - r.t_first) / (max_new - 1) * 1e3 for r in done]
    log(f"    served {st['requests']} requests x {prompt_len}-token prompts, {st['tokens']} "
        f"tokens in {wall:.3f} s: TTFT mean {st['ttft_mean_s'] * 1e3:.1f} ms, latency mean "
        f"{st['latency_mean_s'] * 1e3:.1f} ms, decode {np.mean(decode_ms):.2f} ms/token "
        f"per lane ({slots} lanes), throughput {st['throughput_tok_s']:.2f} tok/s "
        f"(generated tokens / span); peak device memory {peak / 2**30:.2f} GiB (weights "
        f"{weights / 2**30:.2f} GiB, a wave's caches {caches / 2**30:.2f} GiB); launches "
        f"{launches}")
    check(peak - weights - caches <= activations_gib * 2**30,
          f"peak device memory {peak / 2**30:.2f} GiB exceeds the weights and caches by more "
          f"than {activations_gib} GiB")
    log(f"    first tokens: {[r.out_tokens[:4] for r in done[:2]]}")

    toks = np.stack(prompts[:slots])
    eng.cache = None
    profile_run(lambda: model.prefill(params, {"tokens": toks}, max_seq),
                f"one prefill ({slots} x {prompt_len} tokens)", top=10)
    _, cache = model.prefill(params, {"tokens": toks}, max_seq)
    step = np.zeros((slots, 1), np.int32)
    profile_run(lambda: [model.decode_step(params, step, cache) for _ in range(4)],
                f"4 decode steps ({slots} lanes)")
    return launches


def phase_model_card_vs_cpu(arch: str, phase: int, depth: int, prompt_len: int = 128,
                            requests: int = 2, max_new: int = 8) -> None:
    """``arch`` at full width and depth ``depth``, float32, on the card and on
    the CPU with the same weights: prefill and decode logits within a stated
    tolerance, and the same greedy tokens."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    free_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products on the card
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), n_layers=depth, dtype="float32")
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device=DEV)
    p_card = card.init(0)
    p_cpu = copy.deepcopy(p_card).to("cpu")  # the same weights, drawn once on the card
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(requests, prompt_len))
    max_seq = prompt_len + max_new
    # prefill logits: fp32 products summed in other orders; decode steps of
    # a model with a conv state: that state is cached in bf16 after the
    # prefill (as in the reference), so a value near a rounding boundary may
    # round one bf16 ulp (2^-8 relative) apart on the two devices and feed
    # every later step; a dense model's KV cache stays fp32
    tol_prefill = 2e-3
    tol_decode = 1e-2 if cfg.ssm is not None else tol_prefill
    worst = []
    t_cpu = t_card = 0.0
    outs = {}
    for name, model, params in (("cpu", cpu, p_cpu), ("card", card, p_card)):
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": toks}, max_seq)
        steps = [logits.float().cpu()]
        tok = steps[0][:, -1, :cfg.vocab].argmax(-1, keepdim=True)
        greedy = [tok]
        for _ in range(max_new - 1):
            # both devices are fed the CPU's greedy tokens, so their logits
            # stay comparable even if a token differed
            feed = outs["cpu"][1][len(greedy) - 1] if name == "card" else tok
            logits, cache = model.decode_step(params, feed.numpy(), cache)
            steps.append(logits.float().cpu())
            tok = steps[-1][:, -1, :cfg.vocab].argmax(-1, keepdim=True)
            greedy.append(tok)
        if name == "card":
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
        else:
            t_cpu = time.perf_counter() - t0
        outs[name] = (steps, greedy)
    for i, (a, c) in enumerate(zip(outs["cpu"][0], outs["card"][0])):
        tol = tol_prefill if i == 0 else tol_decode
        err = float((a - c).abs().max())
        check(torch.allclose(c, a, atol=tol, rtol=tol),
              f"card and CPU logits differ at step {i}: max abs {err} (atol = rtol = {tol})")
        worst.append(err)
    same = all(torch.equal(a, c) for a, c in zip(outs["cpu"][1], outs["card"][1]))
    check(same, "card and CPU greedy tokens differ")
    log(f"[{phase}] {arch} full width, depth {depth}, float32, {requests} x {prompt_len}-token "
        f"prompts, {max_new} greedy tokens: card == CPU tokens; logits max abs diff per step "
        f"{[float(f'{e:.3g}') for e in worst]} (atol = rtol = {tol_prefill} for the "
        f"prefill, {tol_decode} for decode); cpu {t_cpu:.2f} s, card {t_card:.2f} s")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    t_start = time.perf_counter()

    def elapsed(phases: str) -> None:
        log(f"    phases {phases} done, {time.perf_counter() - t_start:.1f} s since the start")

    smi = phase_device()
    phase_build()
    kernels = [phase_sweep(), phase_patch()]
    launches = phase_main()
    phase_card_vs_cpu()
    # the BFS kernels' launches on both search paths: the replica polish
    # (phase 5) and the default replicas=1 polish (phase 7)
    sym, sym_res = phase_symmetric()
    log(f"    launches on the main paths: replica polish {launches}, symmetric polish {sym}")
    launches = {name: launches[name] + sym[name] for name in launches}
    phase_symmetric_pinned()
    phase_symmetric_card_vs_cpu()
    phase_circulant()
    elapsed("1-10")
    kernels += [phase_flash(), phase_ssd()]
    elapsed("11-12")
    # the model kernels' launches on the three serving paths
    served = [phase_serve("zamba2-2.7b", 13)]
    phase_model_card_vs_cpu("zamba2-2.7b", 14, depth=6)
    elapsed("13-14")
    served.append(phase_serve("qwen3-32b", 15))
    phase_model_card_vs_cpu("qwen3-32b", 16, depth=2)
    elapsed("15-16")
    served.append(phase_serve("mamba2-2.7b", 17))
    phase_model_card_vs_cpu("mamba2-2.7b", 18, depth=4)
    elapsed("17-18")
    # the BFS kernels' launches on the invariants' paths: Table 1 (phase 19)
    # and the whole-graph check of phase 7's graph (phase 20)
    invariants = [phase_table1(), phase_whole_graph(sym_res)]
    elapsed("19-20")
    # and on the paper's 256-node suite (phase 21): its four searched builds
    # and every graph's stats
    suite, g8 = phase_suite256()
    invariants.append(suite)
    elapsed("21")
    # the paper's step 4 (phase 22: the layout and the remesh, apsp on the
    # card), its collectives (phase 23: one apsp for the round counts) and
    # its table and figure modules (phase 24: Table 1's stats)
    step4 = []
    busy, wall = profile_run(lambda: step4.extend(
        [phase_layout_remesh(g8), phase_collectives(), phase_paper_scripts()]), "phases 22-24")
    invariants += step4
    log(f"    phases 22-24: the card idle {100 * (1 - busy / wall):.2f}% of {wall:.1f} s "
        f"(torch.profiler, this process; phase 23's NCCL rank, a process of its own, "
        f"spent {NCCL_MS[0]:.2f} ms in its calls on its host clock, outside the trace)")
    elapsed("22-24")
    log(f"    launches on the invariants' paths: Table 1 {invariants[0]}, "
        f"whole graph {invariants[1]}, 256-node suite {invariants[2]}, "
        f"layout and remesh {invariants[3]}, collectives {invariants[4]}, "
        f"tables and figures {invariants[5]}")
    for run in invariants:
        launches = {name: launches[name] + run[name] for name in launches}
    log(f"    launches on the serving paths: zamba2 {served[0]}, qwen3 {served[1]}, "
        f"mamba2 {served[2]}")
    launches.update({name: sum(run[name] for run in served) for name in served[0]})
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
