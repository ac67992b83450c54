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
   polish_iters=16)`` on the card, with both kernels' launches counted (the
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
    ``scaled_dot_product_attention`` beside the kernel as a yardstick; and
    the same for the model zoo's other prefills (grok-1-314b: b=4, h=48,
    kv=8, s=1024, hd=128; kimi-k2-1t-a32b: h=64, kv=8, hd=112; qwen2-vl-2b:
    h=12, kv=2, s=1088, hd=128; whisper-tiny: h=kv=6, hd=64, its encoder
    non-causal at s=1500, its decoder at s=4, its cross-attention 4 queries
    against 1500 keys), and 300 launches back to back of each mask at
    qwen2-vl's s=1088, where a warpgroup of the last query tile has no
    rows; then the zoo's training shapes (``ZOO_TRAIN_ATTN``: grok-1-314b
    and kimi-k2-1t-a32b at b=1, qwen2-vl-2b at b=8, s=1088, phi3-medium-14b
    at b=8, h=48, kv=12) also at a relative Frobenius 1e-2, and timed;
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
    (phase 23's NCCL rank, a process of its own, apart);
25. phase 13 for grok-1-314b (moe, 8 experts x fe 32768, top-2) at full
    width, depth 6 of 64 (58.0 GiB of bf16 weights, each expert drawn on
    its own): 6 attention launches per prefill; the prefill's profile puts
    the MoE FFN's routing, dispatch, expert GEMMs and combine apart, and
    the decode step's bound (every weight read once) is logged;
26. the same for kimi-k2-1t-a32b (384 experts x fe 2048, top-8, a shared
    expert, hd 112) at depth 2 of 61 (68.0 GiB): 2 launches per prefill;
27. qwen2-vl-2b (vlm, M-RoPE) at full width and depth through
    ``Model.prefill``/``decode_step``: 8 requests in 2 waves of 4, each
    1024 seeded patch embeddings and 64 text tokens, (3, 4, 1088)
    positions (the image on a 32x32 grid, t = 0, h = row, w = col; the text
    at 32 + i on all three streams), 32 greedy tokens; 28 launches per
    prefill; then one text-only wave of 4 through ``ServingEngine``;
28. whisper-tiny (encdec) at full width and depth through
    ``Model.prefill``/``decode_step``: 8 requests of 1500 seeded frames
    and 4-token prompts, 64 greedy tokens (max_seq 128), in 2 waves of 4;
    12 launches per prefill (4 encoder at s = 1500, 4 decoder, 4 cross);
29. card == CPU in float32 with the same weights for qwen2-vl-2b at depth
    2 (images and distinct streams), whisper-tiny at full depth (frames)
    and kimi-k2-1t-a32b at depth 1 with its experts cut to 16 (top-8, the
    shared expert and hd 112 kept), each teacher-forced layer by layer
    (their attention logits reach a std of 60-130 under the reference's
    init, and a free float32 run of whisper-tiny ends O(1) apart; the free
    runs are logged), kimi's routing on both devices equal;
30. the wgmma fragment layouts of the bf16 attention backward kernels
    (``wgmma_bwd_layout_probe``, at head dims 16-128), then the backward
    (``flash_attention_bwd``: D, dK/dV, dQ; bf16 on the tensor cores, fp32
    on the CUDA cores) against ``flash_attention_bwd_plain`` on the
    kernel's own o and lse (relative Frobenius error of dq, dk, dv: 1e-2 in
    bf16, 1e-5 in fp32) at the training shapes (qwen3-32b: b=4, h=64, kv=8,
    s=1024, hd=128, causal; whisper-tiny at b=8: the encoder non-causal at
    s=1500, the decoder at s=448, cross-attention of 448 queries against
    1500 keys; zamba2-2.7b: b=8, h=kv=32, s=1024, hd=80, causal; the
    zoo's, ``ZOO_TRAIN_ATTN``), GQA, head dims 16-128, ragged tails,
    q_offset > 0 and fp32; the forward's lse output against the plain
    forward's; two calls at qwen3's shape bit for bit; 300 launches back to
    back at qwen2-vl-2b's (b=8, h=12, kv=2, s=1088), each equal to the
    first; the training shapes timed beside their bound, the split's
    7-product floor, SDPA's backward and the CUDA-core design's time; then
    the bf16 SSD backward's fragment layouts (``ssd_bwd_wgmma_layout_probe``
    at seven (p, n)), then the SSD backward (``ssd_intra_chunk_bwd``: bf16
    in its domain on the tensor-core passes ``ssd_bwd_col_bf16_kernel`` and
    ``ssd_bwd_row_bf16_kernel``, fp32 and bf16 outside it on
    ``ssd_intra_chunk_bwd_kernel``, then the finish; each case names its
    kernel) against ``ssd_intra_chunk_bwd_plain`` (dx, dB, dC within 1e-2
    of their largest magnitude in bf16, 1e-5 in fp32; ddt and dA 1e-5) at
    mamba2-2.7b's and zamba2-2.7b's training shapes (b*h=640, s=1024, p=64,
    n=128 and 64, chunk 256, dt = softplus of a normal) in bf16 and fp32,
    at nine small and edge shapes (p, n 1-128, chunks 16-512, dt = 0
    padding rows) and at seven edges of the bf16 domain (chunks 64-512, p
    and n 16-128); two calls at mamba2's shape bit for bit; p = 136 refused
    before any launch; both training shapes timed beside their bound, the
    plain version and the CUDA-core design's time, and the CUDA-core
    kernel at mamba2's shape in fp32;
31. the main training path: ``Trainer`` on qwen3-32b at full width, depth 2,
    bf16, remat "full", 2 microbatches, AdamW (lr 1e-3, 8 steps, warmup 1),
    ``SyntheticLM`` at seq 1024 and global batch 8, 8 steps: per-step loss,
    grad norm, lr and time, tokens/s, model FLOP/s, peak memory against the
    reckoning, 8 forward and 4 backward attention launches a step, and a
    profile of one more step (busy share, both attention kernels, GEMMs,
    the loss, the optimizer, the attention backward's share of the step);
32. whisper-tiny training at full width and depth (bf16, seq 448, global
    batch 8, 8 steps, a checkpoint every 4): a run that crashes at step 4
    through the failure hook, restored by a fresh ``Trainer`` and trained
    to step 8, equal to the uninterrupted run bit for bit (losses, weights
    and the optimizer's state); the checkpoint's leaf names equal to the
    JAX package's (pinned);
33. one float32 train step on the card and on the CPU from the same weights
    and batch: qwen3-32b at full width, depth 1 (b=2, s=128) and
    whisper-tiny at full depth (its wq and wk at fan-in d_model; the
    reference's init logged): loss and grad norm (1e-4), every gradient
    tensor (1e-3) and every updated weight (2.2 lr) within tolerance;
34. mamba2-2.7b training at full width and depth (64 layers, bf16, the
    config's AdamW, per-layer checkpointing and one microbatch;
    ``SyntheticLM`` at seq 1024, global batch 8, 6 steps): per-step loss,
    grad norm, lr and time, the median step, tokens/s, peak memory against
    the reckoning, 128 SSD forward and 64 backward launches a step, a
    profile of one more step with the SSD backward's share, each of its
    passes apart; then step 0
    again with ``ssd_intra_chunk_bwd_plain`` on the card in the kernel's
    place: equal losses, grad norms within ``STEP0_GAP_TOL`` (1e-3; 3e-3
    for zamba2, whose step moves 7e-4 to 1.2e-3 with fp32-rounding-sized
    noise on the SSD backward's outputs); then mamba2-2.7b at depth 2, 4
    steps with a checkpoint every 2, restarted after a crash at step 2 bit
    for bit against the uninterrupted run;
35. the same for zamba2-2.7b at full width and depth (54 Mamba2 layers,
    the shared attention block at 9 stages, per-stage checkpointing): 108
    SSD forward and 54 backward, 18 attention forward and 9 backward
    launches a step;
36. phase 33 for mamba2-2.7b at depth 2 and zamba2-2.7b at depth 6 (one
    stage), b=1, s=256 (one chunk of 256), with the SSD launches checked;
37. grok-1-314b training as phase 31 (``phase_train``): full width, depth 1
    of 64, all 8 experts (6.53 B parameters), bf16, the config's Adafactor,
    remat "full" and 8 microbatches, seq 1024, global batch 8, 6 steps;
    model FLOPs count the top-2 experts a token meets; peak memory against
    an Adafactor reckoning (``_reckoning``); the profiled step with the MoE
    stages and the optimizer's span apart;
38. kimi-k2-1t-a32b the same at depth 1 with 16 experts (top-8, the shared
    expert, hd 112); then 4 steps with a crash at step 2 and a restore,
    bit for bit against the uninterrupted run (``phase_restart``: losses,
    weights, Adafactor's statistics);
39. qwen2-vl-2b at full width and depth (28 layers, AdamW, remat "dots":
    56 forward and 28 backward attention launches a step), seq 1088 (1024
    image embeddings and 64 text tokens, the pipeline's M-RoPE streams);
    then its restart at depth 2;
40. phi3-medium-14b (padded 48/12 heads): served at full width and depth
    (40 layers), its depth-2 float32 prefill and decode on the card against
    the CPU (teacher-forced, as phase 29), trained at depth 4 under AdamW
    and "dots";
41. phase 33 for kimi-k2-1t-a32b at depth 1 with 16 experts (Adafactor;
    the routing of every MoE call equal on both devices), qwen2-vl-2b at
    depth 2 (1024 image embeddings, distinct M-RoPE streams) and
    phi3-medium-14b at depth 1, each with wq and wk at fan-in d_model;
42. zamba2-2.7b's restart at depth 12 (two stages: the shared block and
    the attention backward twice), bit for bit.

It prints one ``{"kernels": [...]}`` JSON line (per kernel: launches on the
main paths (the BFS kernels: phases 5, 7, 19, 20, 21, 22, 23 and 24; the
model kernels: phases 13, 15, 17, 25-28, 40 and the training phases 31-42,
where the attention and SSD backward kernels launch),
the largest difference from the plain version, kernel, plain and library
times from CUDA events around a run of calls, and the least time the card
could take), then the
``{"ok": true, "device": {...}}`` line last.  It imports nothing of JAX or
of the JAX package ``repro``.  Without CUDA, or outside a checkout, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
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
SSD_BWD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
KERNELS = ("bfs_sweep_kernel", "minplus_patch_kernel", "flash_attention_kernel",
           "ssd_intra_chunk_kernel", "flash_attention_bwd_dot_kernel",
           "flash_attention_bwd_dkdv_bf16_kernel", "flash_attention_bwd_dq_bf16_kernel",
           "flash_attention_bwd_dkdv_kernel", "flash_attention_bwd_dq_kernel",
           "ssd_intra_chunk_bwd_kernel", "ssd_intra_chunk_bwd_finish_kernel",
           "ssd_bwd_col_bf16_kernel", "ssd_bwd_row_bf16_kernel")
# the SSD backward's launches on the bf16 training paths: the two passes
# and the finish
SSD_BWD_BF16_KERNELS = ("ssd_bwd_col_bf16_kernel", "ssd_bwd_row_bf16_kernel",
                        "ssd_intra_chunk_bwd_finish_kernel")
# the attention backward's kernels on the bf16 training paths
BWD_BF16_KERNELS = ("flash_attention_bwd_dot_kernel", "flash_attention_bwd_dkdv_bf16_kernel",
                    "flash_attention_bwd_dq_bf16_kernel")
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
               proposal_batch: int = 4, polish_iters: int = 16) -> dict:
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
        r = large_search(n, k, polish_iters=2, delta=delta, device=DEV, **kw)
        walls[delta].append(time.perf_counter() - t0)
        runs[delta] = (r.graph.edges, r.mpl, r.diameter, r.history, r.accepted)
    check(runs[False] == runs[True], "delta=False and delta=True trajectories differ")
    log(f"    2 iterations: delta=False {walls[False]} s, delta=True {walls[True]} s, "
        f"same trajectory (mpl={float(runs[True][1])!r}, accepted={runs[True][4]})")
    for delta in (False, True):
        profile_run(lambda: large_search(n, k, polish_iters=2, delta=delta,
                                         device=DEV, **kw), f"2 iterations, delta={delta}")
    return launches


def profile_run(fn, label: str, top: int = 6, ranges: dict | None = None,
                spans: tuple = ()) -> tuple[float, float, dict]:
    """Device time of one run by kernel (torch.profiler), against its wall
    time: how much of the run keeps the card busy.  ``ranges`` maps a label
    to a (module, function name): each such function runs inside a
    ``record_function`` range of that label for the run, and the device
    time of the kernels it launched is reported.  ``spans`` names
    ``record_function`` ranges the program opens itself, reported the same
    way.  Host events are traced only for ranges or spans; else only the
    device's activity is (phases 22-24's host events took the profiler
    66 s to collect and parse, 4 decode steps' about 8 s).  Returns the
    device's busy seconds, the wall seconds and each hand-written kernel's
    device ms by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, f):
        def wrapped(*a, **kw):
            with record_function(name):
                return f(*a, **kw)
        return wrapped

    saved = {name: (mod, attr, getattr(mod, attr)) for name, (mod, attr) in (ranges or {}).items()}
    t_start = time.perf_counter()
    try:
        for name, (mod, attr, f) in saved.items():
            setattr(mod, attr, ranged(name, f))
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if saved or spans else [])
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mod, attr, f in saved.values():
            setattr(mod, attr, f)
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
    kernel_ms = {}
    for name in KERNELS:
        hit = [(us, count) for us, count, key in rows if re.search(rf"\b{name}\b", key)]
        kernel_ms[name] = sum(h[0] for h in hit) / 1e3
        log(f"      {kernel_ms[name]:10.2f} ms  x{sum(h[1] for h in hit):<5d} "
            f"{name} (all instantiations)")
    gemm = [(us, count) for us, count, key in rows
            if re.search(r"gemm|nvjet|xmma|cutlass|cublas", key, re.IGNORECASE)]
    log(f"      {sum(g[0] for g in gemm) / 1e3:10.2f} ms  x{sum(g[1] for g in gemm):<5d} "
        f"GEMMs (cuBLAS kernels)")
    # the device time of the kernels launched inside each range
    for e in averages:
        if (e.key in saved or e.key in spans) and e.device_type == DeviceType.CPU:
            log(f"      {e.device_time_total / 1e3:10.2f} ms  x{e.count:<5d} in {e.key}")
    return busy, wall, kernel_ms


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


# the attention shapes of the moe, vlm and encdec serving prefills (phases
# 25-28): (label, b, h, kv, sq, skv, hd, causal), bf16
MODEL_ZOO_ATTN = (
    ("grok-1-314b", 4, 48, 8, 1024, 1024, 128, True),
    ("kimi-k2-1t-a32b", 4, 64, 8, 1024, 1024, 112, True),
    ("qwen2-vl-2b", 4, 12, 2, 1088, 1088, 128, True),
    ("whisper-tiny encoder", 4, 6, 6, 1500, 1500, 64, False),
    ("whisper-tiny decoder", 4, 6, 6, 4, 4, 64, True),
    ("whisper-tiny cross-attention", 4, 6, 6, 4, 1500, 64, False),
)


def phase_flash(serving=((4, 32, 32, 1024, 80), (4, 64, 8, 1024, 128))) -> dict:
    """flash_attention_kernel (bf16) and flash_attention_fp32_kernel against
    their plain version on the card, after a check of the wgmma fragment
    layouts the bf16 kernel rests on; then timed at each serving prefill's
    shape (b, h, kv, s, hd): zamba2-2.7b's and qwen3-32b's, and the model
    zoo's other families' (``MODEL_ZOO_ATTN``: GQA 6:1, hd 112, a 1500-key
    ragged non-causal tail, 4 queries against 1500 keys).  The kernels line
    takes qwen3-32b's (the dense prefill launches it most)."""
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
    cases += [(b, h, kv, sq, skv, hd, 0, b16, causal)
              for _, b, h, kv, sq, skv, hd, causal in MODEL_ZOO_ATTN]
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
    # a warpgroup past the sequence's end (sq % 128 in 1..64: qwen2-vl's
    # 1088) in work tiles that are not its block's last, 300 launches back
    # to back of each mask: a lagging warp there once deadlocked the block
    for causal in (True, False):
        q, k, v = qkv(4, 12, 2, 1088, 1088, 128, b16)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        for _ in range(300):
            got = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(err <= tol[b16], f"flash_attention_kernel != plain after 300 launches at "
              f"sq=skv=1088 causal={causal}: {err}")
        log(f"[11] flash b=4 h=12 kv=2 sq=skv=1088 hd=128 bfloat16 causal={causal}, 300 "
            f"launches back to back: max abs err {err:.3g} (tol {tol[b16]})")
        errs.append(err)
        del q, k, v, got, want
    # the zoo's training shapes (phases 37-40) on the main path's layout,
    # also held at a relative Frobenius 1e-2, then timed
    for label, b, h, kv, sq, skv, hd, causal in ZOO_TRAIN_ATTN:
        mk = lambda *shape: rnd(*shape).to(b16).transpose(1, 2)
        q, k, v = mk(b, sq, h, hd), mk(b, skv, kv, hd), mk(b, skv, kv, hd)
        got = fa.flash_attention_fwd(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        check(err <= tol[b16] and rel <= 1e-2, f"flash_attention_kernel != plain at {label}'s "
              f"training shape: max abs {err} (tol {tol[b16]}), relative Frobenius {rel}")
        errs.append(err)
        log(f"[11] flash {label} training shape b={b} h={h} kv={kv} s={sq} hd={hd} causal={causal}"
            f": max abs err {err:.3g} (tol {tol[b16]}), relative Frobenius {rel:.3g} (tol 1e-2)")
        del q, k, v, got, want
    for label, b, h, kv, sq, skv, hd, causal in MODEL_ZOO_ATTN:
        log(f"    {label}:")
        flash_timed(rnd, b, h, kv, sq, skv, hd, causal)
    for label, b, h, kv, sq, skv, hd, causal in ZOO_TRAIN_ATTN:
        log(f"    {label}:")
        flash_timed(rnd, b, h, kv, sq, skv, hd, causal, kind="training")
    for b, h, kv, s, hd in serving:
        row = flash_timed(rnd, b, h, kv, s, s, hd)
    return {"name": "flash_attention_kernel", "route": "cuda", "source": FLASH_SOURCE,
            "replaces": "src/repro/kernels/flash_attention.py:38", "max_abs_err": max(errs),
            **row}


def flash_timed(rnd, b: int, h: int, kv: int, sq: int, skv: int, hd: int,
                causal: bool = True, kind: str = "serving") -> dict:
    """The bf16 kernel, its plain version and SDPA (GQA by ``enable_gqa``)
    at one serving prefill's shape, on the main path's layout: (b, h, s, hd)
    views of (b, s, h, hd) tensors; the bound from its FLOPs (the causal
    part only, where causal) and bytes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    q = rnd(b, sq, h, hd).to(torch.bfloat16).transpose(1, 2)
    k, v = (rnd(b, skv, kv, hd).to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal), reps=3, n=1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=hd ** -0.5, enable_gqa=kv != h))
    flops = 4 * b * h * _attn_pairs(sq, skv, 0, causal) * hd  # q k^T and p v
    nbytes = 2 * b * hd * (2 * sq * h + 2 * skv * kv)  # q, k, v read, o written, bf16
    bms, by, terms = bound(nbytes, [(flops, BF16_FLOP_PER_S)])
    s = f"s={sq}" if sq == skv else f"sq={sq} skv={skv}"
    log(f"    {kind} shape b={b} h={h} kv={kv} {s} hd={hd} causal={causal}: kernel {ms:.4f} ms "
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
    """Model kernel launches one prefill makes: an attention per dense, moe
    or vlm layer, per application of the hybrid's shared block, per encoder
    layer and two per decoder layer (self and cross); an SSD per Mamba2
    layer."""
    attn = {"dense": cfg.n_layers, "moe": cfg.n_layers, "vlm": cfg.n_layers, "ssm": 0,
            "hybrid": cfg.n_layers // max(cfg.shared_attn_every, 1),
            "encdec": cfg.enc_layers + 2 * cfg.n_layers}[cfg.family]
    return {"flash_attention_kernel": attn,
            "ssd_intra_chunk_kernel": cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0}


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if hasattr(t, "numel"))


def free_device() -> None:
    """Drop what earlier phases left in the caching allocator, so a model
    that needs most of the card finds it."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _model_cfg(arch: str, depth: int | None = None, experts: int | None = None, **change):
    """``arch``'s config at full width, cut to ``depth`` layers and an MoE
    config to ``experts`` experts if given."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if depth is not None:
        change["n_layers"] = depth
    if experts is not None:
        change["moe"] = dataclasses.replace(cfg.moe, n_experts=experts)
    return dataclasses.replace(cfg, **change)


def _moe_ranges() -> dict:
    """The MoE FFN's stages, for ``profile_run``'s ranges."""
    from repro_torch.models import moe

    return {"moe routing": (moe, "_route"), "moe dispatch": (moe, "_dispatch"),
            "moe expert GEMMs": (moe, "_experts"), "moe combine": (moe, "_combine")}


def phase_serve(arch: str, phase: int, slots: int = 4, requests: int = 8,
                prompt_len: int = 1024, max_new: int = 32, max_seq: int = 1088,
                activations_gib: float = 6.0, depth: int | None = None) -> dict:
    """The serving path of ``arch`` at full width and depth (or ``depth``
    layers), bf16: the kernels' launches, TTFT, decode latency, throughput
    and peak memory, which must stay within ``activations_gib`` of the
    weights and the caches; then a profile of one prefill (an MoE FFN's
    routing, dispatch, expert GEMMs and combine apart) and of 4 decode
    steps."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.serve import DecodeParams, Request, ServingEngine

    free_device()
    cfg = _model_cfg(arch, depth)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)  # the CUDA device: no device argument
    params = model.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.parameters())
    weights = _tensor_bytes(params.parameters())
    cut = "" if depth is None else f" at depth {cfg.n_layers}"
    log(f"[{phase}] {arch}{cut}: {n_params / 1e9:.3f} B parameters ({cfg.dtype}, "
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
    log(f"    first tokens: {[r.out_tokens[:4] for r in done[:2]]}; a decode step reads "
        f"every weight: {weights / HBM_BYTES_PER_S * 1e3:.2f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s is its bound")

    toks = np.stack(prompts[:slots])
    eng.cache = None
    profile_run(lambda: model.prefill(params, {"tokens": toks}, max_seq),
                f"one prefill ({slots} x {prompt_len} tokens)", top=10,
                ranges=_moe_ranges() if cfg.moe is not None else None)
    _, cache = model.prefill(params, {"tokens": toks}, max_seq)
    step = np.zeros((slots, 1), np.int32)
    profile_run(lambda: [model.decode_step(params, step, cache) for _ in range(4)],
                f"4 decode steps ({slots} lanes)")
    return launches


def mrope_positions(b: int, img: int, txt: int) -> np.ndarray:
    """(3, b, img + txt) M-RoPE positions: the image on a side x side grid
    (t = 0, h = row, w = col), then the text at side + i on all three
    streams."""
    side = int(round(img ** 0.5))
    if side * side != img:
        raise ValueError(f"{img} image tokens are not a square grid")
    i = np.arange(img)
    grid = np.stack([np.zeros(img), i // side, i % side])
    text = np.broadcast_to(side + np.arange(txt), (3, txt))
    return np.broadcast_to(np.concatenate([grid, text], axis=1)[:, None],
                           (3, b, img + txt)).astype(np.int32)


def model_batch(cfg, rng, b: int, prompt_len: int) -> dict:
    """A seeded prefill batch of ``b`` prompts: tokens; for vlm also
    ``img_tokens`` image embeddings (before the text) and their M-RoPE
    positions; for encdec ``enc_seq`` frames."""
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(b, prompt_len)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.standard_normal((b, cfg.img_tokens, cfg.d_model),
                                                  dtype=np.float32)
        batch["positions"] = mrope_positions(b, cfg.img_tokens, prompt_len)
    elif cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    return batch


def phase_generate(arch: str, phase: int, slots: int = 4, requests: int = 8,
                   prompt_len: int = 64, max_new: int = 32, max_seq: int = 1152,
                   activations_gib: float = 6.0) -> dict:
    """The vlm or encdec path of ``arch`` at full width and depth, bf16,
    through ``Model.prefill``/``decode_step`` (the engine passes only tokens
    to prefill, as the reference's does, so it takes no images or frames):
    ``requests`` prompts in waves of ``slots``, each wave prefilled with its
    seeded images and M-RoPE positions (vlm) or frames (encdec), then
    ``max_new`` greedy tokens a lane, each copied home and fed back as the
    engine does.  The kernels' launches, TTFT, decode latency, throughput
    and peak memory against the weights and the caches, then a profile of
    one prefill."""
    import torch

    from repro_torch.models import build_model

    free_device()
    cfg = _model_cfg(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)  # the CUDA device: no device argument
    params = model.init(0)
    torch.cuda.synchronize()
    weights = _tensor_bytes(params.parameters())
    log(f"[{phase}] {arch}: {sum(t.numel() for t in params.parameters()) / 1e9:.3f} B "
        f"parameters ({cfg.dtype}, {weights / 2**30:.2f} GiB) made on {model.device} in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    waves = [model_batch(cfg, rng, slots, prompt_len) for _ in range(-(-requests // slots))]

    def greedy(batch, steps):
        logits, cache = model.prefill(params, batch, max_seq)
        out = [logits[:, -1, :cfg.vocab].float().argmax(-1).to(torch.int32).cpu().numpy()]
        t_first = time.perf_counter()
        finite = bool(torch.isfinite(logits[..., :cfg.vocab].float()).all())
        for _ in range(steps - 1):
            logits, cache = model.decode_step(params, out[-1][:, None], cache)
            out.append(logits[:, -1, :cfg.vocab].float().argmax(-1).to(torch.int32)
                       .cpu().numpy())
        return np.stack(out, 1), t_first, finite, cache

    greedy(waves[0], 2)  # warm-up
    torch.cuda.synchronize()
    _reset_model_counts()
    torch.cuda.reset_peak_memory_stats()
    ttft, decode_ms, tokens, finite = [], [], [], []
    t_start = time.perf_counter()
    for batch in waves:
        t0 = time.perf_counter()
        toks, t_first, fin, cache = greedy(batch, max_new)
        t_done = time.perf_counter()
        ttft.append(t_first - t0)
        decode_ms.append((t_done - t_first) / (max_new - 1) * 1e3)
        tokens.append(toks)
        finite.append(fin)
    wall = time.perf_counter() - t_start
    launches = _model_counts()
    peak = torch.cuda.max_memory_allocated()
    caches = _tensor_bytes(cache.values())
    want = {k: len(waves) * v for k, v in launches_per_prefill(cfg).items()}
    check(launches == want, f"model kernel launches {launches}, expected {want}")
    check(all(finite), f"prefill logits not finite: {finite}")
    check(all(((0 <= t) & (t < cfg.vocab)).all() and t.shape == (slots, max_new)
              for t in tokens), "a sampled token is outside the vocab, or one is missing")
    extra = {k: v.shape for k, v in waves[0].items() if k != "tokens"}
    log(f"    {requests} requests in {len(waves)} waves of {slots}, {prompt_len}-token prompts "
        f"with {extra}, {max_new} greedy tokens each, in {wall:.3f} s: TTFT mean "
        f"{np.mean(ttft) * 1e3:.1f} ms (a wave's prefill and first token), decode "
        f"{np.mean(decode_ms):.2f} ms/token per lane ({slots} lanes), throughput "
        f"{requests * max_new / wall:.2f} tok/s; peak device memory {peak / 2**30:.2f} GiB "
        f"(weights {weights / 2**30:.2f} GiB, a wave's caches {caches / 2**30:.3f} GiB); "
        f"launches {launches}; first tokens {tokens[0][:2, :4].tolist()}")
    check(peak - weights - caches <= activations_gib * 2**30,
          f"peak device memory {peak / 2**30:.2f} GiB exceeds the weights and caches by more "
          f"than {activations_gib} GiB")
    profile_run(lambda: model.prefill(params, waves[0], max_seq),
                f"one prefill ({slots} prompts, {extra})", top=10)
    return launches


class _TeacherForcing:
    """Layer by layer, the card against the CPU: the CPU's run records each
    layer call's input and outputs; the card's run feeds every layer call
    the CPU's input to the same call in place of its own and holds each of
    its outputs to the CPU's within ``tol`` of that output's largest
    magnitude (fp32 products of width d_model differ by their summation
    order in proportion to the row's norm, not to each element)."""

    def __init__(self, tol: float):
        from repro_torch.models import encdec, transformer

        self.fns = [(transformer, "dense_layer"), (transformer, "dense_layer_decode"),
                    (encdec, "_enc_layer"), (encdec, "_dec_layer"),
                    (encdec, "_dec_layer_decode")]
        self.tol = tol
        self.calls: list = []
        self.worst = 0.0
        self.bad: list = []

    @staticmethod
    def _flat(out) -> list:
        return [t for o in (out if isinstance(out, tuple) else (out,))
                for t in (_TeacherForcing._flat(o) if isinstance(o, tuple) else (o,))]

    def run(self, mode: str, fn):
        """``fn()`` with the layer functions recording ("cpu") or forced
        ("card")."""
        saved = [(mod, name, getattr(mod, name)) for mod, name in self.fns]
        it = iter(self.calls)

        import torch

        def wrap(name, f):
            def layer(p, x, *a, **kw):
                if mode == "cpu":
                    out = f(p, x, *a, **kw)
                    self.calls.append((name, x.clone(), [t.clone() for t in self._flat(out)]))
                    return out
                rec_name, x_cpu, outs_cpu = next(it)
                check(rec_name == name, f"layer calls differ: {rec_name} on the CPU, {name}")
                out = f(p, x_cpu.to(x.device), *a, **kw)
                for got, want in zip(self._flat(out), outs_cpu):
                    want = want.float()
                    rel = float((got.float().cpu() - want).abs().max() / want.abs().max())
                    self.worst = max(self.worst, rel)
                    if not rel <= self.tol:
                        self.bad.append((name, len(self.bad), rel))
                return out
            return layer

        try:
            for mod, name, f in saved:
                setattr(mod, name, wrap(name, f))
            return fn()
        finally:
            for mod, name, f in saved:
                setattr(mod, name, f)


@contextlib.contextmanager
def _recorded_routes(into: list):
    """``moe._route`` with each call's expert ids (t, k) copied home into
    ``into``, for the body of the ``with``."""
    from repro_torch.models import moe

    route = moe._route

    def recorded(xf, router, m):
        out = route(xf, router, m)
        into.append(out[2].cpu())
        return out

    moe._route = recorded
    try:
        yield into
    finally:
        moe._route = route


def _route_flips(cpu: list, card: list) -> list:
    """(call, tokens routed otherwise) for each MoE call whose expert ids
    differ between the two devices' records."""
    import torch

    return [(i, int((a != c).any(-1).sum())) for i, (a, c) in enumerate(zip(cpu, card))
            if not torch.equal(a, c)]


def phase_model_card_vs_cpu(arch: str, phase: int, depth: int, prompt_len: int = 128,
                            requests: int = 2, max_new: int = 8, forced: bool = False,
                            **change) -> None:
    """``arch`` at full width and depth ``depth`` (its config otherwise
    changed by ``change``), float32, on the card and on the CPU with the
    same weights: prefill and decode logits within a stated tolerance, and
    the same greedy tokens.  A vlm batch carries seeded image embeddings
    with distinct M-RoPE streams, an encdec batch seeded frames.

    With ``forced``, the card's checked run is teacher-forced layer by layer
    (``_TeacherForcing``), each layer's outputs held to the CPU's: the
    model zoo's families without qk-norm have attention logits of std
    ~60-130 at full width under the reference's init (``wq``/``wk`` take
    their fan-in from the head count), where a near tie between keys can
    turn a float32 rounding difference into a visible one; through
    whisper-tiny's 4 encoder layers over 1500 frames one layer multiplies a
    difference in its input by ~16, so two correct float32 runs end O(1)
    apart.  The free-running card's distance from the CPU is logged beside
    it, unchecked.  An MoE config's routing (every
    token's top-k expert ids) is recorded on both devices in the checked
    runs: a flip is reported, and fails the phase."""
    import copy

    import torch

    from repro_torch.models import build_model

    free_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products on the card
    torch.backends.cudnn.allow_tf32 = False
    cfg = _model_cfg(arch, depth, dtype="float32", **change)
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device=DEV)
    p_card = card.init(0)
    p_cpu = copy.deepcopy(p_card).to("cpu")  # the same weights, drawn once on the card
    batch = model_batch(cfg, np.random.default_rng(1), requests, prompt_len)
    max_seq = cfg.img_tokens + prompt_len + max_new
    # prefill logits: fp32 products summed in other orders; decode steps of
    # a model with a conv state: that state is cached in bf16 after the
    # prefill (as in the reference), so a value near a rounding boundary may
    # round one bf16 ulp (2^-8 relative) apart on the two devices and feed
    # every later step; a dense model's KV cache stays fp32
    tol_prefill = 2e-3
    tol_decode = 1e-2 if cfg.ssm is not None else tol_prefill
    forcing = _TeacherForcing(tol_prefill) if forced else None
    routes: dict = {"cpu": [], "card": []}

    def run(name, model, params, feed=None):
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, max_seq)
        steps = [logits.float().cpu()]
        greedy = [steps[0][:, -1, :cfg.vocab].argmax(-1, keepdim=True)]
        for i in range(max_new - 1):
            # the card is fed the CPU's greedy tokens, so the two devices'
            # logits stay comparable even if a token differed
            tok = feed[i] if feed is not None else greedy[-1]
            logits, cache = model.decode_step(params, tok.numpy(), cache)
            steps.append(logits.float().cpu())
            greedy.append(steps[-1][:, -1, :cfg.vocab].argmax(-1, keepdim=True))
        if name != "cpu":
            torch.cuda.synchronize()
        return steps, greedy, time.perf_counter() - t0

    def diffs(a, c):
        return [float((x - y).abs().max()) for x, y in zip(a, c)]

    with _recorded_routes(routes["cpu"]):
        ref = (forcing.run("cpu", lambda: run("cpu", cpu, p_cpu)) if forced
               else run("cpu", cpu, p_cpu))
    if forced:
        free = run("card, free", card, p_card, feed=ref[1])
        same = all(torch.equal(a, c) for a, c in zip(ref[1], free[1]))
        log(f"    free-running card against the CPU (logged, not checked): logits max abs "
            f"diff per step {[float(f'{e:.3g}') for e in diffs(ref[0], free[0])]}, greedy "
            f"tokens {'equal' if same else 'differ'}")
    with _recorded_routes(routes["card"]):
        out = (forcing.run("card", lambda: run("card", card, p_card, feed=ref[1])) if forced
               else run("card", card, p_card, feed=ref[1]))
    if cfg.moe is not None:
        flips = _route_flips(routes["cpu"], routes["card"])
        log(f"    routing: {len(routes['cpu'])} MoE calls, {sum(a.shape[0] for a in routes['cpu'])}"
            f" token routings of top-{cfg.moe.top_k} over {cfg.moe.n_experts} experts; calls "
            f"with a token routed otherwise on the card: {flips}")
        check(not flips, f"a routing flip between the card and the CPU: (call, tokens) {flips}")
    if forced:
        log(f"    teacher-forced: {len(forcing.calls)} layer calls, worst max abs diff "
            f"{forcing.worst:.3g} of the output's largest magnitude (tol {forcing.tol})")
        check(not forcing.bad, f"layer outputs differ on the card beyond {forcing.tol} of their "
              f"largest magnitude: (layer, index, relative) {forcing.bad[:8]}")
    worst = []
    for i, (a, c) in enumerate(zip(ref[0], out[0])):
        tol = tol_prefill if i == 0 else tol_decode
        err = float((a - c).abs().max())
        check(torch.allclose(c, a, atol=tol, rtol=tol),
              f"card and CPU logits differ at step {i}: max abs {err} (atol = rtol = {tol})")
        worst.append(err)
    same = all(torch.equal(a, c) for a, c in zip(ref[1], out[1]))
    check(same, "card and CPU greedy tokens differ")
    extra = {k: v.shape for k, v in batch.items() if k != "tokens"}
    log(f"[{phase}] {arch} full width, depth {depth}"
        f"{f', {change}' if change else ''}, float32, {requests} x {prompt_len}-token prompts"
        f"{f' with {extra}' if extra else ''}, {max_new} greedy tokens"
        f"{', teacher-forced' if forced else ''}: card == CPU tokens; logits max abs diff per "
        f"step {[float(f'{e:.3g}') for e in worst]} (atol = rtol = {tol_prefill} for the "
        f"prefill, {tol_decode} for decode); cpu {ref[2]:.2f} s, card {out[2]:.2f} s")


# ---------------------------------------------------------------------------
# Training (phases 30-33)
# ---------------------------------------------------------------------------

# the zoo's training shapes (phases 37-40): grok-1-314b and kimi-k2-1t-a32b
# at 8 microbatches of 1, qwen2-vl-2b's 1024 image embeddings and 64 text
# tokens (a 64-row tail), phi3-medium-14b's padded 48/12 heads
ZOO_TRAIN_ATTN = (
    ("grok-1-314b", 1, 48, 8, 1024, 1024, 128, True),
    ("kimi-k2-1t-a32b", 1, 64, 8, 1024, 1024, 112, True),
    ("qwen2-vl-2b", 8, 12, 2, 1088, 1088, 128, True),
    ("phi3-medium-14b", 8, 48, 12, 1024, 1024, 128, True),
)
# the attention backward's shapes on the training paths (phases 31, 32, 35
# and 37-40): (label, b, h, kv, sq, skv, hd, causal), bf16, b a microbatch
TRAIN_ATTN = (
    ("qwen3-32b", 4, 64, 8, 1024, 1024, 128, True),
    ("whisper-tiny encoder", 8, 6, 6, 1500, 1500, 64, False),
    ("whisper-tiny decoder", 8, 6, 6, 448, 448, 64, True),
    ("whisper-tiny cross-attention", 8, 6, 6, 448, 1500, 64, False),
    ("zamba2-2.7b", 8, 32, 32, 1024, 1024, 80, True),
) + ZOO_TRAIN_ATTN
# the SSD backward's shapes on the training paths (phases 34-35): (label,
# b*h, s, p, n, chunk), bf16 x/B/C, b a microbatch of 8 and 80 heads
TRAIN_SSD = (
    ("mamba2-2.7b", 640, 1024, 64, 128, 256),
    ("zamba2-2.7b", 640, 1024, 64, 64, 256),
)
# the names of the JAX package's checkpoint leaves for whisper-tiny under
# AdamW (``repro.checkpoint.ckpt._flatten_with_paths`` of its Trainer's
# state tree, in order, joined by newlines): their count and sha256, pinned
# here since this script imports nothing of ``repro``
WHISPER_CKPT_NAMES = (82, "dde96b25f9d39527bd1ba68580095b8f2765cd582cdd19573aff3389f2049f98")


# the bf16 attention backward's ms before its tensor-core redesign (the
# CUDA-core design's three launches), by TRAIN_ATTN label: quoted from
# PERF.md section 6, row 3b (NVIDIA H100 80GB HBM3, 700.00 W), for the log
# only; no run of this script measures them
BWD_MS_BEFORE = {"qwen3-32b": 14.5499, "whisper-tiny encoder": 4.1909}


def _rel_fro(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def phase_flash_bwd() -> dict:
    """The attention backward kernels, after a check of the wgmma fragment
    layouts the bf16 kernels rest on (``wgmma_bwd_layout_probe``), against
    ``flash_attention_bwd_plain`` on the same inputs (the kernel's own o and
    lse): the training shapes of qwen3-32b and whisper-tiny, then GQA, head
    dims 16-128, a ragged tail, q_offset > 0 and fp32; the forward's lse
    output against the plain forward's; two calls at qwen3-32b's shape bit
    for bit.  Then the five training shapes timed beside their bound, the
    split's seven-product floor, SDPA's backward (``enable_gqa``) and, where
    PERF.md has it, the CUDA-core design's time."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=DEV).manual_seed(3)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    f32, b16 = torch.float32, torch.bfloat16

    # the fragment layouts: S^T = k q^T, dP^T = v do^T, then bf16(S^T) do
    # and bf16(dP^T) q from the dK/dV kernel's own loads, descriptors and
    # products, each register written where the kernels take it to lie (the
    # dQ kernel's products take the same layouts); the products are exact,
    # so only the order of the fp32 sums differs (1e-5 of the largest value;
    # a misplaced register is off by the values themselves)
    for hd_ in (16, 24, 64, 80, 128):
        q, do = (rnd(64, hd_).to(b16) for _ in range(2))
        k, v = (rnd(128, hd_).to(b16) for _ in range(2))
        s_k, dp_k, dv_k, dk_k = fa.wgmma_bwd_layout_probe(q, do, k, v)
        want = [k.float() @ q.float().T, v.float() @ do.float().T,
                s_k.bfloat16().float() @ do.float(), dp_k.bfloat16().float() @ q.float()]
        torch.cuda.synchronize()
        got = [s_k, dp_k, dv_k[:, :hd_], dk_k[:, :hd_]]
        err = [float((g - w).abs().max()) for g, w in zip(got, want)]
        tol = [1e-5 * float(w.abs().max()) for w in want]
        check(all(e <= t for e, t in zip(err, tol)) and not bool(dv_k[:, hd_:].any())
              and not bool(dk_k[:, hd_:].any()),
              f"the backward's wgmma fragment layout is wrong at hd={hd_}: S^T, dP^T, dV, dK "
              f"errors {err} (tol {tol})")
        log(f"[30] backward wgmma fragment layout hd={hd_}: S^T err {err[0]:.3g}, dP^T "
            f"{err[1]:.3g}, bf16(S^T) dO {err[2]:.3g}, bf16(dP^T) Q {err[3]:.3g} (tol "
            f"{max(tol):.3g})")
    # relative Frobenius error of dq, dk and dv: both sides sum in fp32 in
    # other orders and round to the storage type once
    tol = {b16: 1e-2, f32: 1e-5}
    tol_lse = {b16: 1e-3, f32: 1e-5}
    cases = [(b, h, kv, sq, skv, hd, 0, b16, causal)
             for _, b, h, kv, sq, skv, hd, causal in TRAIN_ATTN]
    cases += [(2, 8, 2, 200, 328, 128, 128, b16, True),
              (2, 8, 2, 200, 328, 128, 128, f32, True),
              (1, 4, 4, 77, 205, 80, 128, b16, True),
              (2, 4, 2, 19, 19, 16, 0, b16, True),
              (2, 4, 2, 19, 19, 16, 0, f32, True),
              (2, 6, 2, 128, 256, 112, 0, b16, False),
              (2, 6, 2, 130, 257, 112, 0, f32, False),
              (2, 4, 2, 128, 128, 64, 0, f32, True),
              (1, 64, 8, 256, 256, 128, 0, f32, True),
              (1, 6, 6, 64, 1500, 64, 0, f32, False)]
    # and whisper-tiny's encoder with its logits' spread under the
    # reference's init (std about 100: q and k drawn 10x wider), where P is
    # nearly one-hot and dS a small difference
    cases = [(*case, 1.0) for case in cases] + [(2, 6, 6, 1500, 1500, 64, 0, b16, False, 10.0)]
    errs, lse_errs = [], []
    launches = fa.flash_attention_bwd.launches
    for b_, h_, kv_, sq, skv, hd_, off, dtype, causal, wide in cases:
        mk = lambda *shape: rnd(*shape).to(dtype).transpose(1, 2)  # the model's layout
        q, k = (wide * mk(b_, s_, n_, hd_) for s_, n_ in ((sq, h_), (skv, kv_)))
        v, do = mk(b_, skv, kv_, hd_), mk(b_, sq, h_, hd_)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off, return_lse=True)
        _, lse_p = fa.flash_attention_plain_lse(q, k, v, causal=causal, q_offset=off)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, q_offset=off)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        e_lse = float((lse - lse_p).abs().max())
        e = [_rel_fro(g, w) for g, w in zip(got, want)]
        label = (f"b={b_} h={h_} kv={kv_} sq={sq} skv={skv} hd={hd_} q_offset={off} "
                 f"{str(dtype)[6:]} causal={causal}" + (f" q, k x{wide:g}" if wide != 1 else ""))
        # the lse's error grows with the logits' magnitude (fp32 sums)
        check(e_lse <= tol_lse[dtype] * wide,
              f"the forward's lse != the plain forward's: {e_lse} at {label}")
        check(max(e) <= tol[dtype] and all(np.isfinite(e)),
              f"attention backward kernel != plain: dq, dk, dv relative errors {e} > "
              f"{tol[dtype]} at {label}")
        errs.append(max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)))
        lse_errs.append(e_lse)
        log(f"[30] attention backward {label}: relative Frobenius error dq {e[0]:.3g}, dk "
            f"{e[1]:.3g}, dv {e[2]:.3g} (tol {tol[dtype]}); lse max abs err {e_lse:.3g} "
            f"(tol {tol_lse[dtype] * wide:g})")
        del q, k, v, do, o, lse, got, want
    # no atomics and a fixed order of summation: two calls on the same
    # inputs give the same bits (a restart from a checkpoint repeats a run)
    _, b_, h_, kv_, sq, skv, hd_, causal = TRAIN_ATTN[0]
    mk = lambda *shape: rnd(*shape).to(b16).transpose(1, 2)
    q, k, v = mk(b_, sq, h_, hd_), mk(b_, skv, kv_, hd_), mk(b_, skv, kv_, hd_)
    do = mk(b_, sq, h_, hd_)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, c)) for a, c in zip(first, second)]
    check(all(same), f"two backward calls at qwen3-32b's shape differ: dq, dk, dv equal {same}")
    log("[30] attention backward at qwen3-32b's shape, two calls: dq, dk, dv bit for bit equal")
    del q, k, v, do, o, lse, first, second
    # qwen2-vl's training shape (a 64-row tail past 1024, where a rowless
    # warpgroup once trapped the forward), 300 launches back to back: each
    # the same bits as the first
    _, b_, h_, kv_, sq, skv, hd_, causal = ZOO_TRAIN_ATTN[2]
    q, k, v, do = mk(b_, sq, h_, hd_), mk(b_, skv, kv_, hd_), mk(b_, skv, kv_, hd_), mk(b_, sq, h_, hd_)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    same = True
    for _ in range(299):
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        same = same and all(bool(torch.equal(a, c)) for a, c in zip(got, first))
    torch.cuda.synchronize()
    e = [_rel_fro(g, w) for g, w in zip(got, want)]
    check(same and max(e) <= tol[b16], f"the attention backward over 300 launches at b={b_} "
          f"h={h_} kv={kv_} s={sq}: all equal to the first {same}, dq, dk, dv relative errors {e}")
    log(f"[30] attention backward b={b_} h={h_} kv={kv_} s={sq} hd={hd_} causal={causal}, 300 "
        f"launches back to back: each bit for bit the first's; relative Frobenius error dq "
        f"{e[0]:.3g}, dk {e[1]:.3g}, dv {e[2]:.3g} (tol {tol[b16]})")
    del q, k, v, do, o, lse, first, got, want
    check(fa.flash_attention_bwd.launches == launches + len(cases) + 2 + 300,
          "the backward wrapper did not count its launches")
    fa.flash_attention_bwd.launches = launches  # comparisons do not count

    rows = [flash_bwd_timed(rnd, *shape, before=BWD_MS_BEFORE.get(label))
            for label, *shape in TRAIN_ATTN]
    return {"name": "flash_attention_bwd_kernel", "route": "cuda", "source": FLASH_SOURCE,
            "replaces": "none: the JAX package differentiates its jnp attention "
                        "(src/repro/models/attention.py:42); backward of "
                        "src/repro/kernels/flash_attention.py:38",
            "max_abs_err": max(errs), "max_lse_err": max(lse_errs), **rows[0],
            "whisper_encoder_ms": rows[1]["ms"], "whisper_decoder_ms": rows[2]["ms"],
            "whisper_cross_ms": rows[3]["ms"], "zamba2_ms": rows[4]["ms"],
            "zoo_train_ms": {label: row["ms"] for (label, *_), row
                             in zip(ZOO_TRAIN_ATTN, rows[-len(ZOO_TRAIN_ATTN):])}}


def flash_bwd_timed(rnd, b: int, h: int, kv: int, sq: int, skv: int, hd: int,
                    causal: bool, before: float | None) -> dict:
    """The backward kernels (the three launches of one call), their plain
    version and SDPA's backward (``torch.autograd.grad`` through
    ``scaled_dot_product_attention`` with ``enable_gqa``) at one training
    shape, bf16, on the main path's layout; the bound from 2.5x the
    forward's FLOPs (5 products against 2) and the bytes of q, k, v, o, do
    and lse read and dq, dk, dv written; the split's own floor, its 7
    products (S and dP in both passes) at the bf16 peak, logged; ``before``,
    the CUDA-core design's ms at this shape as PERF.md quotes it (or None),
    logged beside the kernels' time.  Returns what this call measured and
    the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    mk = lambda *shape: rnd(*shape).to(torch.bfloat16).transpose(1, 2)
    q, do = mk(b, sq, h, hd), mk(b, sq, h, hd)
    k, v = mk(b, skv, kv, hd), mk(b, skv, kv, hd)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    n0 = fa.flash_attention_bwd.launches
    ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal), reps=3, n=5)
    fa.flash_attention_bwd.launches = n0
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal),
                       reps=3, n=1)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, scale=hd ** -0.5,
                                         enable_gqa=kv != h)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True))
    fwd_flops = 4 * b * h * _attn_pairs(sq, skv, 0, causal) * hd
    flops = 2.5 * fwd_flops
    nbytes = 2 * b * hd * (3 * sq * h + 2 * skv * kv) + 4 * b * h * sq  # q, o, do, k, v, lse
    nbytes += 2 * b * hd * (sq * h + 2 * skv * kv)  # dq, dk, dv written
    bms, by, terms = bound(nbytes, [(flops, BF16_FLOP_PER_S)])
    floor7 = 3.5 * fwd_flops / BF16_FLOP_PER_S * 1e3
    s = f"s={sq}" if sq == skv else f"sq={sq} skv={skv}"
    log(f"    training shape b={b} h={h} kv={kv} {s} hd={hd} causal={causal}: backward kernels "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of the 5-product count, "
        f"{3.5 * fwd_flops / ms / 1e9:.1f} of the split's 7), plain {plain_ms:.3f} ms, SDPA "
        f"backward {lib_ms:.4f} ms ({ms / lib_ms:.2f}x the kernels' time is SDPA's), bound "
        f"{bms:.4f} ms ({terms}; {flops / 1e9:.2f} GFLOP at {BF16_FLOP_PER_S / 1e12:.0f} "
        f"TFLOP/s bf16, {HBM_BYTES_PER_S / 1e12:.2f} TB/s), the split's 7-product floor "
        f"{floor7:.4f} ms"
        + ("" if before is None else f"; the CUDA-core design, {before} ms here in PERF.md "
           f"(not measured in this run), took {before / ms:.1f}x as long"))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


# the bf16 SSD backward's ms before its tensor-core redesign (the CUDA-core
# design's two launches), by TRAIN_SSD label, and the training steps' ms
# with it: quoted from PERF.md section 6, row 4b (NVIDIA H100 80GB HBM3,
# 700.00 W), for the log only; no run of this script measures them
SSD_BWD_MS_BEFORE = {"mamba2-2.7b": 10.0071, "zamba2-2.7b": 4.7822}
SSM_STEP_MS_BEFORE = {"mamba2-2.7b": 2664.1, "zamba2-2.7b": 1929.5}


def _ssd_bwd_probe(rnd) -> None:
    """The bf16 SSD backward's fragment layouts (``ssd_bwd_wgmma_layout_probe``)
    at (p, n) of every padded width, against the same split arithmetic in
    PyTorch: the column pass's S^T = B C^T and dW^T = X gy^T (gy split in
    shared memory into three terms), W^T gy and dS^T C from register A
    operands (two terms) and MN-major gy and C, B gst^T (three terms), X gst
    (two), u, and the row pass's dW = gy X^T (two terms).  The products are
    exact, so only the order of the fp32 sums differs (1e-5 of the largest
    value); a misplaced register or a wrong swizzle is off by the values."""
    import torch

    from repro_torch.kernels import ssd_scan as ssd

    def split(v, terms):
        parts = []
        for _ in range(terms):
            parts.append(v.bfloat16().float())
            v = v - parts[-1]
        return parts

    torch.backends.cuda.matmul.allow_tf32 = False  # the references in full fp32
    b16 = torch.bfloat16
    for p, n in ((64, 128), (64, 64), (16, 16), (48, 80), (128, 128), (32, 112), (128, 16)):
        B, C = (rnd(64, n).to(b16) for _ in range(2))
        X = rnd(64, p).to(b16)
        gy, gst, Wt, Dt = rnd(64, p), rnd(p, n), rnd(64, 64), rnd(64, 64)
        got = ssd.ssd_bwd_wgmma_layout_probe(B, C, X, gy, gst, Wt, Dt)
        Bf, Cf, Xf = B.float(), C.float(), X.float()
        g3, s3 = split(gy, 3), split(gst, 3)
        (wh, wl), (dh, dl) = split(Wt, 2), split(Dt, 2)
        gb = sum(Bf @ t.T for t in s3)
        want = {"s": Bf @ Cf.T, "dw": sum(Xf @ t.T for t in g3),
                "dx": wh @ g3[0] + wh @ g3[1] + wl @ g3[0], "db": dh @ Cf + dl @ Cf, "gb": gb,
                "xg": Xf @ s3[0] + Xf @ s3[1], "u": (Xf * gb).sum(-1),
                "dwr": g3[0] @ Xf.T + g3[1] @ Xf.T}
        torch.cuda.synchronize()
        err = {k: float((got[k] - w).abs().max() / w.abs().max()) for k, w in want.items()}
        check(all(e <= 1e-5 for e in err.values()),
              f"the SSD backward's wgmma fragment layout is wrong at p={p}, n={n}: relative "
              f"errors {err} (tol 1e-5)")
        log(f"[30] ssd backward wgmma fragment layout p={p} n={n}: "
            + ", ".join(f"{k} {v:.3g}" for k, v in err.items()) + " (tol 1e-5)")


def phase_ssd_bwd() -> list[dict]:
    """The SSD backward (``ssd_intra_chunk_bwd``), after a check of the
    fragment layouts the bf16 passes rest on (``_ssd_bwd_probe``), against
    ``ssd_intra_chunk_bwd_plain`` on the same inputs: mamba2-2.7b's and
    zamba2-2.7b's training shapes in bf16 (the tensor-core passes,
    ``ssd_bwd_col_bf16_kernel`` and ``ssd_bwd_row_bf16_kernel``) and fp32
    (``ssd_intra_chunk_bwd_kernel``, CUDA cores) (dt = softplus of a normal,
    so cs falls to about -200 over a chunk of 256, where the reference's
    fp32 gradient overflows), then small and edge shapes: in the bf16
    domain chunks of 64 to 512 (an odd count of 64-row tiles at 192), p
    and n at 16, 48, 80 and 128, dt = 0 padding rows; outside it (p 8,
    chunk 80) and in fp32 on the CUDA cores (p, n from 1 to 128, ragged
    64-row tiles, chunks of 16 to 512); each case's log names the kernel
    that took it, chosen by dtype and shape (``bwd_kernel``).  Two calls at
    mamba2's shape bit for bit; a shape outside both domains refused before
    any launch; both training shapes timed beside their bound, and the
    CUDA-core kernel at mamba2's shape in fp32.  Part of phase 30.  Returns the kernels
    line's rows: the bf16 passes, then the CUDA-core kernel."""
    import torch

    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device=DEV).manual_seed(4)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    f32, b16 = torch.float32, torch.bfloat16

    def inputs(bh, s, p, n, chunk, dtype, pad=0):
        x = rnd(bh, s, p).to(dtype)
        B = (0.5 * rnd(bh, s, n)).to(dtype)
        C = (0.5 * rnd(bh, s, n)).to(dtype)
        dt = torch.nn.functional.softplus(rnd(bh, s))  # as the model makes dt
        A = -torch.exp(0.5 * rnd(bh, 1))
        if pad:  # ops.ssd_scan's padding rows
            for t in (x, B, C, dt):
                t[:, s - pad:] = 0
        return x, dt, A, B, C, rnd(bh, s, p), rnd(bh, s // chunk, p, n)

    def in_bf16_domain(p, n, chunk, dtype):
        return dtype == b16 and chunk % 64 == 0 and p % 16 == 0 and n % 16 == 0

    _ssd_bwd_probe(rnd)
    # relative to each gradient's largest magnitude: both sides sum in fp32
    # in other orders (cs, the sums of G, R and dA in fp64 on both), 1e-5;
    # dx, dB and dC in bf16 are rounded once from fp32 sums that differ in
    # their last bits, so an element may land one bf16 step (2^-8 of itself)
    # away, 1e-2
    tol = {(b16, True): 1e-2, (b16, False): 1e-5, (f32, True): 1e-5, (f32, False): 1e-5}
    names = ("dx", "ddt", "dA", "dB", "dC")
    cases = [(*shape, dtype, 0) for _, *shape in TRAIN_SSD for dtype in (b16, f32)]
    cases += [(8, 64, 8, 16, 16, f32, 0), (8, 64, 8, 16, 16, b16, 5),
              (3, 96, 24, 40, 48, f32, 7), (2, 256, 128, 128, 256, b16, 0),
              (2, 256, 128, 128, 256, f32, 0), (2, 64, 1, 1, 64, f32, 0),
              (2, 1024, 64, 128, 512, b16, 0), (4, 160, 16, 16, 80, b16, 0),
              (2, 128, 100, 72, 128, f32, 3)]
    # the bf16 domain's edges: chunk 64 and 512, an odd tile count (192), p
    # and n at 16, 48, 80, 128, padding rows
    cases += [(4, 128, 16, 16, 64, b16, 0), (2, 512, 48, 80, 256, b16, 7),
              (2, 384, 80, 48, 128, b16, 0), (3, 1024, 128, 128, 512, b16, 3),
              (2, 192, 32, 112, 64, b16, 0), (2, 576, 64, 128, 192, b16, 5),
              (2, 512, 128, 16, 256, b16, 0)]
    errs = {"ssd_bwd_col_bf16_kernel": [], "ssd_intra_chunk_bwd_kernel": []}
    launches = ssd.ssd_intra_chunk_bwd.launches
    bf16_launches = ssd.ssd_intra_chunk_bwd.bf16_launches
    for bh, s, p, n, chunk, dtype, pad in cases:
        args = inputs(bh, s, p, n, chunk, dtype, pad)
        x, dt, _, B, C, gy, gst = args
        kernel = ssd.bwd_kernel(x, dt, B, C, gy, gst, chunk)
        bf16 = in_bf16_domain(p, n, chunk, dtype)
        label = (f"bh={bh} s={s} p={p} n={n} chunk={chunk} {str(dtype)[6:]}"
                 + (f", {pad} padding rows" if pad else ""))
        check(kernel == ("ssd_bwd_col_bf16_kernel" if bf16 else "ssd_intra_chunk_bwd_kernel"),
              f"the SSD backward at {label} would take {kernel}")
        n_bf16 = ssd.ssd_intra_chunk_bwd.bf16_launches
        got = ssd.ssd_intra_chunk_bwd(*args, chunk)
        want = ssd.ssd_intra_chunk_bwd_plain(*args, chunk)
        torch.cuda.synchronize()
        check(ssd.ssd_intra_chunk_bwd.bf16_launches == n_bf16 + bf16,
              f"the SSD backward at {label} did not launch {kernel}")
        e = [float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30))
             for g, w in zip(got, want)]
        t = [tol[dtype, name in ("dx", "dB", "dC")] for name in names]
        check(all(np.isfinite(e)) and all(a <= b for a, b in zip(e, t))
              and all(bool(torch.isfinite(g).all()) for g in got),
              f"{kernel} != plain at {label}: relative errors "
              f"{dict(zip(names, e))} (tol {dict(zip(names, t))})")
        check(tuple(g.dtype for g in got) == (dtype, f32, f32, dtype, dtype),
              f"the SSD backward's dtypes at {label}: {[g.dtype for g in got]}")
        errs[kernel].append(max(float((g.float() - w.float()).abs().max())
                                for g, w in zip(got, want)))
        log(f"[30] ssd backward {label} ({kernel}): max error relative to the largest magnitude "
            + ", ".join(f"{k} {v:.3g}" for k, v in zip(names, e))
            + f" (tol {t[0]:g} dx/dB/dC, {t[1]:g} ddt/dA)")
        del args, got, want
    # no atomics and a fixed order of summation: two calls give the same bits
    _, bh, s, p, n, chunk = TRAIN_SSD[0]
    args = inputs(bh, s, p, n, chunk, b16)
    first = ssd.ssd_intra_chunk_bwd(*args, chunk)
    second = ssd.ssd_intra_chunk_bwd(*args, chunk)
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, c)) for a, c in zip(first, second)]
    check(all(same), f"two SSD backward calls at mamba2's shape differ: {dict(zip(names, same))}")
    log("[30] ssd backward at mamba2-2.7b's training shape (ssd_bwd_col_bf16_kernel), two calls: "
        "dx, ddt, dA, dB, dC bit for bit equal")
    del args, first, second
    n_bf16 = sum(in_bf16_domain(p, n, chunk, dtype) for _, _, p, n, chunk, dtype, _ in cases)
    check(ssd.ssd_intra_chunk_bwd.launches == launches + len(cases) + 2
          and ssd.ssd_intra_chunk_bwd.bf16_launches == bf16_launches + n_bf16 + 2,
          "the SSD backward wrapper did not count its launches")
    # a width outside both domains is refused before any launch (no kernel
    # takes it), and the forward on such an input that needs a gradient is
    # refused before its own launch
    x, dt, A, B, C, gy, gst = inputs(2, 64, 136, 16, 64, f32)
    n0 = ssd.ssd_intra_chunk.launches
    for call in (lambda: ssd.ssd_intra_chunk_bwd(x, dt, A, B, C, gy, gst, 64),
                 lambda: ssd.ssd_intra_chunk(x.requires_grad_(), dt, A, B, C, 64)):
        try:
            call()
        except ValueError as exc:
            refused = str(exc)
        else:
            raise RuntimeError("check failed: p = 136 was not refused by the SSD backward")
    check(ssd.ssd_intra_chunk_bwd.launches == launches + len(cases) + 2
          and ssd.ssd_intra_chunk.launches == n0, "a refused SSD call launched")
    log(f"    p = 136 refused before any launch: {refused}")
    ssd.ssd_intra_chunk_bwd.launches = launches  # comparisons do not count
    ssd.ssd_intra_chunk_bwd.bf16_launches = bf16_launches
    rows = [ssd_bwd_timed(inputs(bh, s, p, n, chunk, b16), chunk, label,
                          before=SSD_BWD_MS_BEFORE.get(label))
            for label, bh, s, p, n, chunk in TRAIN_SSD]
    label, bh, s, p, n, chunk = TRAIN_SSD[0]
    core = ssd_bwd_timed(inputs(bh, s, p, n, chunk, f32), chunk, label)
    replaces = ("none: the JAX package differentiates its jnp ssd_chunked_ref "
                "(src/repro/models/ssm.py:83), since jax.grad cannot pass through "
                "pallas_call (src/repro/kernels/ssd_scan.py:75); backward of "
                "src/repro/kernels/ssd_scan.py:32")
    return [{"name": "ssd_intra_chunk_bwd_bf16_kernel", "route": "cuda", "source": SSD_BWD_SOURCE,
             "launches_of": list(SSD_BWD_BF16_KERNELS), "replaces": replaces,
             "max_abs_err": max(errs["ssd_bwd_col_bf16_kernel"]), **rows[0], "library_ms": None,
             "zamba2_ms": rows[1]["ms"], "zamba2_bound_ms": rows[1]["bound_ms"]},
            {"name": "ssd_intra_chunk_bwd_kernel", "route": "cuda", "source": SSD_BWD_SOURCE,
             "replaces": replaces, "max_abs_err": max(errs["ssd_intra_chunk_bwd_kernel"]),
             **core, "library_ms": None}]


def ssd_bwd_timed(args, chunk: int, label: str, before: float | None = None) -> dict:
    """The SSD backward (one call: the kernels ``bwd_kernel`` picks and the
    finish) and its plain version at one training shape; the bound from the
    bytes (x, B, C, dt, gy, gst and A read once; dx, dB, dC, ddt and dA
    written once) and the products on the causal triangles counted once
    (S, dW, dx, dC, dB, and the state terms): for bf16 x, B, C at the bf16
    tensor-core rate with each product that has an fp32 operand counted
    twice (split into two bf16 terms, as the forward's bound counts them),
    for fp32 at the fp32 CUDA-core peak; the same products at the fp32
    CUDA-core peak logged; ``before``, the CUDA-core design's ms at this
    shape as PERF.md quotes it (or None), logged beside.  (The bf16 passes
    are timed apart in phases 34-35's profiled steps: a profile of a few
    calls here recorded no device event on the card.)"""
    import torch

    from repro_torch.kernels import ssd_scan as ssd

    x, dt, A, B, C, gy, gst = args
    bh, s, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    kernel = ssd.bwd_kernel(x, dt, B, C, gy, gst, chunk)
    n0, b0 = ssd.ssd_intra_chunk_bwd.launches, ssd.ssd_intra_chunk_bwd.bf16_launches
    ms = cuda_ms(lambda: ssd.ssd_intra_chunk_bwd(*args, chunk), reps=5, n=5)
    ssd.ssd_intra_chunk_bwd.launches, ssd.ssd_intra_chunk_bwd.bf16_launches = n0, b0
    plain_ms = cuda_ms(lambda: ssd.ssd_intra_chunk_bwd_plain(*args, chunk), reps=3, n=1)
    pairs = chunk * (chunk + 1) // 2  # causal (i, j) pairs of a chunk
    s_flops = bh * nc * 2 * pairs * n  # C B^T, bf16 operands
    other = bh * nc * (pairs * (4 * p + 4 * n) + 4 * chunk * p * n)  # dW, dx, dC, dB; state
    es = x.element_size()
    nbytes = (2 * bh * s * (p + 2 * n) * es  # x, B, C read; dx, dB, dC written
              + 2 * bh * s * 4 + bh * s * p * 4 + bh * nc * p * n * 4 + 2 * bh * 4)
    if x.dtype == torch.bfloat16:
        bms, by, terms = bound(nbytes, [(s_flops + 2 * other, BF16_FLOP_PER_S)])
    else:
        bms, by, terms = bound(nbytes, [(s_flops + other, FP32_FLOP_PER_S)])
    floor_ms = (s_flops + other) / FP32_FLOP_PER_S * 1e3
    smem = (" and ".join(map(str, ssd.bf16_bwd_smem_bytes(chunk, p, n))) + " B (the passes)"
            if kernel == "ssd_bwd_col_bf16_kernel" else f"{ssd.bwd_smem_bytes(chunk, p, n)} B")
    log(f"    training shape {label} (bh={bh} s={s} p={p} n={n} chunk={chunk}, "
        f"{str(x.dtype)[6:]} x/B/C; {kernel}, {smem} of shared memory a block): backward "
        f"{ms:.4f} ms ({(s_flops + other) / ms / 1e9:.1f} TFLOP/s of "
        f"{(s_flops + other) / 1e9:.2f} GFLOP), plain {plain_ms:.3f} ms, bound {bms:.4f} ms "
        f"({terms}; {nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; {bms / ms:.1%} of "
        f"it reached), the products at the fp32 CUDA-core peak {floor_ms:.4f} ms "
        f"({FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s)"
        + ("" if before is None else f"; the CUDA-core design, {before} ms here in PERF.md "
           f"(not measured in this run), took {before / ms:.1f}x as long"))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def _train_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    bwd = ssd.ssd_intra_chunk_bwd
    return {"flash_attention_kernel": fa.flash_attention_fwd.launches,
            "flash_attention_bwd_kernel": fa.flash_attention_bwd.launches,
            "ssd_intra_chunk_kernel": ssd.ssd_intra_chunk.launches,
            "ssd_intra_chunk_bwd_kernel": bwd.launches - bwd.bf16_launches,
            "ssd_intra_chunk_bwd_bf16_kernel": bwd.bf16_launches}


def _reset_train_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    _reset_model_counts()
    fa.flash_attention_bwd.launches = ssd.ssd_intra_chunk_bwd.launches = 0
    ssd.ssd_intra_chunk_bwd.bf16_launches = 0


def _trainer(cfg, steps: int, seq: int, batch: int, ckpt_dir=None, ckpt_every: int = 100,
             device=None):
    """A ``Trainer`` as the launcher builds it: the config's optimizer
    through ``make_optimizer(lr=1e-3, total_steps=steps, warmup=1)`` and
    ``SyntheticLM`` at seed 0."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import Trainer

    return Trainer(model=build_model(cfg, device=device),
                   opt=make_optimizer(cfg.optimizer, lr=1e-3, total_steps=steps, warmup=1),
                   data=SyntheticLM(cfg, DataConfig(seq_len=seq, global_batch=batch, seed=0)),
                   ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)


def _attn_calls_per_step(cfg) -> tuple[int, int]:
    """(forward, backward) attention launches of one train step: each
    layer's attentions per microbatch (the hybrid's shared block once a
    stage, the ssm family none), forward once more when a layer or stage is
    recomputed under remat (encdec: its decoder layers' two)."""
    stages = cfg.n_layers // max(cfg.shared_attn_every, 1)
    per = {"dense": cfg.n_layers, "moe": cfg.n_layers, "vlm": cfg.n_layers, "ssm": 0,
           "hybrid": stages, "encdec": cfg.enc_layers + 2 * cfg.n_layers}[cfg.family]
    mb = cfg.microbatches
    recomputed = 0 if cfg.remat == "none" else {
        "encdec": 2 * cfg.n_layers, "ssm": 0, "hybrid": stages}.get(cfg.family, cfg.n_layers)
    return mb * (per + recomputed), mb * per


def _ssd_calls_per_step(cfg) -> tuple[int, int]:
    """(forward, backward) SSD launches of one train step: one forward and
    one backward per Mamba2 layer and microbatch, and the forward once more
    when the layer (ssm) or its stage (hybrid) is recomputed under remat."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0, 0
    mb = cfg.microbatches
    return mb * cfg.n_layers * (1 if cfg.remat == "none" else 2), mb * cfg.n_layers


def _model_flops(cfg, batch: int, seq: int) -> tuple[float, float]:
    """(model FLOPs of one train step, matmul parameters a token meets): 6 x
    the matmul parameters a token meets (its attention projections, its
    FFN: for an MoE layer the router, its top-k experts and the shared
    ones, not the experts it skips; the head) x the step's tokens, plus 3 x
    the attention products of the forward (the causal pairs only)."""
    from repro_torch.models import transformer

    hp, kvp, vp = transformer.padded_dims(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.moe is not None:
        m = cfg.moe
        ffn = d * m.n_experts + 3 * d * m.d_ff_expert * (m.top_k + m.n_shared_experts)
    else:
        ffn = 3 * d * cfg.d_ff
    mm = cfg.n_layers * (d * (hp + 2 * kvp) * hd + hp * hd * d + ffn) + d * vp
    attn_fwd = cfg.n_layers * 4 * hp * hd * _attn_pairs(seq, seq, 0, True) * batch
    return 6 * mm * batch * seq + 3 * attn_fwd, mm


def _reckoning(cfg, tr, state_bytes: int, batch: int, seq: int) -> tuple[float, str]:
    """The training path's device memory, reckoned as the weights and the
    optimizer's state (as allocated) plus the larger of two live sets.  The
    backward's: the gradients (an fp32 accumulator per parameter beside a
    microbatch's gradients in the weights' dtype when there are several
    microbatches), a microbatch's logits (4 fp32 copies at the text
    positions; a vlm's image positions, cut after the head, only the
    output and its gradient in the weights' dtype) and what remat keeps of
    each layer ("dots": every weight product's output; "full": its input).
    The optimizer's, once the logits are gone: the gradients it is given
    (the fp32 accumulator, or the one microbatch's) and its fp32
    temporaries at its largest leaf (Adafactor: its u and u squared;
    AdamW, per tensor: the fp32 gradient, its denominator, its update and
    the fp32 weights).  Returns (bytes, the terms)."""
    from repro_torch.convert import reference_leaves
    from repro_torch.models import transformer

    params = tr.state["params"]
    n = sum(t.numel() for t in params.parameters())
    es = next(params.parameters()).element_size()
    mb = cfg.microbatches
    grads = n * (4 + es if mb > 1 else es)
    given = n * (4 if mb > 1 else es)
    leaves = reference_leaves(cfg, params)
    if tr.opt.name == "adafactor":
        largest = max(math.prod(leaf.shape) for leaf in leaves)
        temps = 2 * 4 * largest
    else:
        largest = max(t.numel() for leaf in leaves for t in leaf.tensors)
        temps = 4 * 4 * largest
    hp, kvp, vp = transformer.padded_dims(cfg)
    hd, d = cfg.resolved_head_dim, cfg.d_model
    rows = batch // mb
    tokens = rows * seq
    img = rows * cfg.img_tokens if cfg.family == "vlm" else 0
    logits = (4 * 4 * (tokens - img) + 2 * es * img) * vp
    if cfg.remat == "dots":
        kept = cfg.n_layers * tokens * ((hp + 2 * kvp) * hd + 2 * d + 2 * cfg.d_ff) * es
    else:
        kept = cfg.n_layers * tokens * d * es
    backward, update = grads + logits + kept, given + temps
    gib = 2**30
    terms = (f"weights and {tr.opt.name} state {state_bytes / gib:.2f} + the larger of the "
             f"backward's {backward / gib:.2f} (gradients {grads / gib:.2f}, logits "
             f"{logits / gib:.2f}, remat {cfg.remat} {kept / gib:.2f}) and the update's "
             f"{update / gib:.2f} (gradients {given / gib:.2f}, temporaries {temps / gib:.2f} at "
             f"the largest {'leaf' if tr.opt.name == 'adafactor' else 'tensor'}, "
             f"{largest / 1e9:.3f} B) GiB")
    return state_bytes + max(backward, update), terms


def phase_train(arch: str, phase: int, depth: int | None = None, steps: int = 6,
                seq: int = 1024, batch: int = 8, experts: int | None = None) -> dict:
    """A training path: ``Trainer`` on ``arch`` at full width (cut to
    ``depth`` layers and ``experts`` experts if given), bf16, the config's
    optimizer, remat and microbatches as the launcher sets them,
    ``SyntheticLM`` at ``seq`` and global batch ``batch`` (a vlm: its
    image embeddings and M-RoPE streams), ``steps`` steps: per-step loss,
    grad norm, lr and time, each finite; the median step, tokens/s, model
    FLOP/s against the bf16 peak (``_model_flops``); peak memory against
    the reckoning (``_reckoning``, 8 GiB allowed); the attention kernels'
    launches per step against ``_attn_calls_per_step``; then a profile of
    one more step with the loss's forward, the MoE stages and the
    optimizer's span apart."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.train import SPAN_GRADS, SPAN_OPTIMIZER

    free_device()
    cfg = _model_cfg(arch, depth, experts)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = _trainer(cfg, steps, seq, batch)  # the CUDA device: no device argument
    tr.init(0)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tr.state["params"].parameters())
    state_bytes = torch.cuda.memory_allocated()
    cut = "" if depth is None else f", depth {cfg.n_layers}"
    cut += "" if experts is None else f", {experts} experts"
    log(f"[{phase}] {arch} training, full width{cut}: {n / 1e9:.3f} B parameters, weights and "
        f"{cfg.optimizer} state {state_bytes / 2**30:.2f} GiB, made in "
        f"{time.perf_counter() - t0:.2f} s; remat {cfg.remat}, {cfg.microbatches} "
        f"microbatch(es), global batch {batch} x {seq} tokens"
        + (f" ({cfg.img_tokens} image embeddings)" if cfg.family == "vlm" else ""))
    _reset_train_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = tr.train(steps, log_every=0)
    wall = time.perf_counter() - t0
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    for h in hist:
        log(f"    step {h['step']}: loss {h['loss']:.4f}, grad norm {h['grad_norm']:.4f}, lr "
            f"{h['lr']:.3g}, {h['time_s'] * 1e3:.1f} ms")
    check(all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist),
          f"an {arch} loss or grad norm is not finite")
    fwd, bwd = _attn_calls_per_step(cfg)
    want = {"flash_attention_kernel": steps * fwd, "flash_attention_bwd_kernel": steps * bwd,
            "ssd_intra_chunk_kernel": 0, "ssd_intra_chunk_bwd_kernel": 0,
            "ssd_intra_chunk_bwd_bf16_kernel": 0}
    check(launches == want, f"{arch} training launches {launches}, expected {want}")
    med = float(np.median([h["time_s"] for h in hist[1:]]))
    flops, mm = _model_flops(cfg, batch, seq)
    reckoned, terms = _reckoning(cfg, tr, state_bytes, batch, seq)
    log(f"    {steps} steps in {wall:.2f} s; median step (steps 1-{steps - 1}) {med * 1e3:.1f} "
        f"ms: {batch * seq / med:.0f} tokens/s, {flops / med / 1e12:.1f} TFLOP/s of model FLOPs "
        f"({flops / 1e12:.2f} TFLOP a step: 6 x {mm / 1e9:.3f} B matmul parameters a token "
        f"meets x {batch * seq} tokens + attention), {100 * flops / med / BF16_FLOP_PER_S:.1f}% "
        f"of {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16; peak device memory "
        f"{peak / 2**30:.2f} GiB (reckoned {reckoned / 2**30:.2f} GiB: {terms}); launches "
        f"{launches}, per step forward {fwd}, backward {bwd}")
    check(peak <= reckoned + 8 * 2**30,
          f"peak device memory {peak / 2**30:.2f} GiB exceeds the reckoning "
          f"{reckoned / 2**30:.2f} GiB by more than 8 GiB")
    ranges = {"cross_entropy_loss (forward)": (transformer, "cross_entropy_loss")}
    if cfg.moe is not None:
        ranges.update(_moe_ranges())
    _, wall, kms = profile_run(lambda: tr.train(1, log_every=0), f"one {arch} train step",
                               top=12, ranges=ranges, spans=(SPAN_GRADS, SPAN_OPTIMIZER))
    bwd_ms = sum(kms[name] for name in BWD_BF16_KERNELS)
    log(f"    the attention backward in the profiled step: {bwd_ms:.2f} ms of {wall * 1e3:.1f} ms "
        f"({100 * bwd_ms / (wall * 1e3):.1f}%; "
        + ", ".join(f"{name} {kms[name]:.2f} ms" for name in BWD_BF16_KERNELS)
        + f"), the forward {kms['flash_attention_kernel']:.2f} ms")
    return launches


def phase_train_whisper(steps: int = 8, seq: int = 448, batch: int = 8, every: int = 4) -> dict:
    """whisper-tiny (encdec) at full width and depth, bf16: ``steps`` steps
    with a checkpoint every ``every``; a second run that crashes (the
    failure hook) at step ``every`` after its checkpoint there, and a fresh
    ``Trainer`` that restores it and trains to ``steps``: its losses,
    final weights and AdamW state against the uninterrupted run's, bit for
    bit (``_restart_matches``); the checkpoint's leaf names against
    the JAX package's; then the backward kernels' first two steps against
    the plain backward's (``_whisper_bwd_plain_gap``)."""
    import hashlib
    import json as _json
    import shutil
    import tempfile

    free_device()
    cfg = _model_cfg("whisper-tiny")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        _reset_train_counts()
        a = _trainer(cfg, steps, seq, batch, ckpt_dir=os.path.join(root, "a"), ckpt_every=every)
        a.init(0)
        t0 = time.perf_counter()
        hist_a = a.train(steps, log_every=0)
        wall = time.perf_counter() - t0
        launches = _train_counts()
        fwd, bwd = _attn_calls_per_step(cfg)
        want = {"flash_attention_kernel": steps * fwd, "flash_attention_bwd_kernel": steps * bwd,
                "ssd_intra_chunk_kernel": 0, "ssd_intra_chunk_bwd_kernel": 0,
                "ssd_intra_chunk_bwd_bf16_kernel": 0}
        check(launches == want, f"whisper training launches {launches}, expected {want}")
        check(all(np.isfinite(h["loss"]) for h in hist_a), "a whisper loss is not finite")
        med = float(np.median([h["time_s"] for h in hist_a[1:]]))
        log(f"[32] whisper-tiny training, full width and depth, bf16, global batch {batch} x "
            f"{seq} tokens against {cfg.enc_seq} frames: {steps} steps in {wall:.2f} s, median "
            f"step {med * 1e3:.1f} ms; losses {[round(h['loss'], 4) for h in hist_a]}; "
            f"launches {launches}")
        with open(os.path.join(root, "a", f"step_{every:09d}", "MANIFEST.json")) as f:
            names = list(_json.load(f)["leaves"])
        digest = hashlib.sha256("\n".join(names).encode()).hexdigest()
        check((len(names), digest) == WHISPER_CKPT_NAMES,
              f"checkpoint leaf names ({len(names)}, {digest}) differ from the JAX package's "
              f"{WHISPER_CKPT_NAMES}")
        _restart_matches(cfg, a, hist_a, steps, seq, batch, every, os.path.join(root, "b"),
                         note=f"; checkpoint leaves {len(names)}, names equal to the JAX "
                              f"package's")
        del a
        _whisper_bwd_plain_gap(cfg, steps, seq, batch)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _restart_matches(cfg, a, hist_a, steps: int, seq: int, batch: int, every: int, ckpt_dir: str,
                     note: str = "") -> None:
    """A second run of ``cfg`` that crashes (the failure hook) at step
    ``every`` after its checkpoint there (in ``ckpt_dir``), and a fresh
    ``Trainer`` that restores it and trains to ``steps``: its losses, final
    weights and optimizer state against the uninterrupted run ``a``'s
    (``hist_a``), bit for bit (the path's kernels and ops are
    deterministic); a difference is reported by tensor and fails."""
    import torch

    from repro_torch.checkpoint import ckpt

    class Crash(RuntimeError):
        pass

    def hook(step):
        if step == every:
            raise Crash(step)

    b = _trainer(cfg, steps, seq, batch, ckpt_dir=ckpt_dir, ckpt_every=every)
    b.init(0)
    b.failure_hook = hook
    try:
        b.train(steps, log_every=0)
    except Crash:
        pass
    check(ckpt.latest_step(ckpt_dir) == every,
          "the crashed run left no checkpoint at its last save")
    del b
    c = _trainer(cfg, steps, seq, batch, ckpt_dir=ckpt_dir, ckpt_every=every)
    check(c.restore() and c.state["step"] == every and c.data.step == every,
          "the fresh Trainer did not restore the step, weights and data stream")
    hist_c = c.train(steps - every, log_every=0)
    la = [h["loss"] for h in hist_a[every:]]
    lc = [h["loss"] for h in hist_c]
    pa = a.state["params"].state_dict()
    pc = c.state["params"].state_dict()
    differ = [k for k in pa if not torch.equal(pa[k], pc[k])]
    sa = dict(ckpt._flatten_with_paths(a.state["opt_state"]))
    sc = dict(ckpt._flatten_with_paths(c.state["opt_state"]))
    state_differ = [k for k in sa if not torch.equal(sa[k], sc[k])]
    worst = max((_rel_fro(pc[k], pa[k]) for k in differ), default=0.0)
    check(la == lc and not differ and sa.keys() == sc.keys() and not state_differ,
          f"the restart from step {every} is not bit for bit: losses {la} vs {lc}, "
          f"{len(differ)} weight tensors differ (worst relative Frobenius {worst:.3g}): "
          f"{differ[:6]}; {a.opt.name} state tensors differ: {state_differ[:6]}")
    log(f"    restart from step {every}: losses {lc}, all {len(pa)} weight tensors and all "
        f"{len(sa)} {a.opt.name} state tensors equal the uninterrupted run's bit for bit{note}")


def _recording(tr) -> list:
    """``tr`` with its optimizer's gradients copied to the host in fp32
    before each update; returns the list the copies go to, a list a step."""
    import torch

    from repro_torch.optim import Optimizer

    seen = []
    inner = tr.opt

    def update(grads, state, leaves, step):
        # copies: the clip scales the gradients in place
        seen.append([g.detach().to("cpu", torch.float32, copy=True)
                     for gs in grads for g in gs])
        return inner.update(grads, state, leaves, step)

    tr.opt = Optimizer(init=inner.init, update=update, name=inner.name)
    tr.__post_init__()  # the step function takes the recording optimizer
    return seen


def _whisper_bwd_plain_gap(cfg, steps: int, seq: int, batch: int) -> None:
    """Two bf16 whisper-tiny steps of phase 32's run, once through the
    backward kernels and once with ``flash_attention_bwd_plain`` (fp32 P
    and dS) on the card in their place, from the same weights and batches:
    the losses, the grad norms and the worst gradient tensor of step 0
    (the same forward, so only the attention backward differs), and the
    loss of step 1 after one AdamW update.  Logged, not checked."""
    from repro_torch.convert import reference_leaves
    from repro_torch.kernels import flash_attention as fa

    runs = []
    for plain in (False, True):
        free_device()
        tr = _trainer(cfg, steps, seq, batch)
        tr.init(0)
        seen = _recording(tr)
        kernels = fa.flash_attention_bwd
        if plain:
            fa.flash_attention_bwd = fa.flash_attention_bwd_plain
        try:
            hist = tr.train(2, log_every=0)
        finally:
            fa.flash_attention_bwd = kernels
        names = [n for leaf in reference_leaves(cfg, tr.state["params"])
                 for n in [leaf.path] * len(leaf.tensors)]
        runs.append((hist, seen[0]))
        del tr, seen
    (hk, gk), (hp, gp) = runs
    worst, where = max((_rel_fro(a, b), n) for n, a, b in zip(names, gk, gp))
    check(all(np.isfinite(h[key]) for h in hk + hp for key in ("loss", "grad_norm")),
          "a whisper loss or grad norm is not finite with the kernels or the plain backward")
    log(f"    bf16 whisper-tiny with the backward kernels / with flash_attention_bwd_plain on "
        f"the card (logged, not checked): step 0 loss {hk[0]['loss']:.6f} / "
        f"{hp[0]['loss']:.6f}, grad norm {hk[0]['grad_norm']:.6f} / {hp[0]['grad_norm']:.6f} "
        f"(relative {abs(hk[0]['grad_norm'] - hp[0]['grad_norm']) / hp[0]['grad_norm']:.3g}); "
        f"gradients: worst relative Frobenius {worst:.3g} ({where}); step 1 loss "
        f"{hk[1]['loss']:.6f} / {hp[1]['loss']:.6f} (relative "
        f"{abs(hk[1]['loss'] - hp[1]['loss']) / hp[1]['loss']:.3g})")


def _card_vs_cpu_step(cfg, b: int, s: int, lr: float, rescale_qk: bool = False) -> dict:
    """One float32 train step of ``cfg`` on the card and on the CPU from the
    card's initial weights (with ``rescale_qk``, every ``wq`` and ``wk``
    first scaled to a fan-in of d_model) and the same batch (a vlm's with
    distinct M-RoPE streams, ``mrope_positions``).  Returns both
    histories, the worst relative Frobenius distance of a gradient tensor
    (the ones the optimizer was given, before its clip), the largest
    updated-weight difference, the largest share of a tensor's elements
    beyond 1e-5 of its magnitude (plus 1e-6), the launches, both times
    and, for an MoE config, the MoE calls whose routing (every token's
    top-k expert ids, the recomputed forward's too) differs between the
    devices."""
    import copy

    import torch

    from repro_torch.convert import reference_leaves

    card = _trainer(cfg, 8, s, b)
    card.init(0)
    if rescale_qk:
        with torch.no_grad():
            for name, t in card.state["params"].named_parameters():
                if name.endswith((".wq", ".wk")):  # (d, heads, hd): fan-in heads -> d
                    t.mul_((t.shape[1] / t.shape[0]) ** 0.5)
    cpu = _trainer(cfg, 8, s, b, device="cpu")
    p_cpu = copy.deepcopy(card.state["params"]).to("cpu")  # the card's weights
    cpu.state = {"params": p_cpu, "step": 0,
                 "opt_state": cpu.opt.init(reference_leaves(cfg, p_cpu))}
    if cfg.family == "vlm":  # the image on a grid, then the text
        for tr in (card, cpu):
            def batch(i=None, draw=tr.data.batch):
                out = draw(i)
                out["positions"] = torch.from_numpy(
                    mrope_positions(b, cfg.img_tokens, s - cfg.img_tokens))
                return out
            tr.data.batch = batch
    g_card, g_cpu = _recording(card), _recording(cpu)
    routes: dict = {"card": [], "cpu": []}

    def run(tr, name):
        with _recorded_routes(routes[name]):
            t0 = time.perf_counter()
            h = tr.train(1, log_every=0)[0]
            return h, time.perf_counter() - t0

    _reset_train_counts()
    hc, t_card = run(card, "card")
    counts = _train_counts()
    hp, t_cpu = run(cpu, "cpu")
    flips = _route_flips(routes["cpu"], routes["card"])
    out = {"card": hc, "cpu": hp, "grad": 0.0, "grad_worst": "", "share": 0.0, "far": 0.0,
           "worst": "", "launches": counts, "t_card": t_card, "t_cpu": t_cpu,
           "routes": (len(routes["cpu"]), len(routes["card"]), flips)}
    names = [n for leaf in reference_leaves(cfg, p_cpu) for n in [leaf.path] * len(leaf.tensors)]
    for name, gc_, gp in zip(names, g_card[0], g_cpu[0]):
        err = _rel_fro(gc_, gp)
        if err > out["grad"]:
            out["grad"], out["grad_worst"] = err, name
    pc = card.state["params"].state_dict()
    for name, want in cpu.state["params"].state_dict().items():
        # in place on a copy: a weight may be gigabytes
        diff = pc[name].to("cpu", copy=True).sub_(want).abs_()
        share = int((diff > 1e-5 * want.abs().max() + 1e-6).sum()) / diff.numel()
        far = float(diff.max())
        if share > out["share"] or far > out["far"]:
            out["worst"] = name
        out["share"], out["far"] = max(out["share"], share), max(out["far"], far)
        del diff
    return out


# phase 33's float32 steps: (arch, depth, b, s, wq and wk rescaled, checked,
# experts)
CARD_VS_CPU_DENSE = (("qwen3-32b", 1, 2, 128, False, True, None),
                     ("whisper-tiny", None, 2, 64, False, False, None),
                     ("whisper-tiny", None, 2, 64, True, True, None))
# phase 36's: mamba2-2.7b at depth 2 and zamba2-2.7b at depth 6, its one
# stage (6 Mamba2 layers and the shared attention block), 256 tokens: one
# chunk of 256, where cs falls to about -200
CARD_VS_CPU_SSM = (("mamba2-2.7b", 2, 1, 256, False, True, None),
                   ("zamba2-2.7b", 6, 1, 256, False, True, None))
# phase 41's: kimi-k2-1t-a32b at depth 1 with 16 experts (Adafactor, the
# shared expert, hd 112), qwen2-vl-2b at depth 2 with its 1024 image
# embeddings and 64 text tokens, phi3-medium-14b at depth 1 (48/12 padded
# heads); none has qk-norm, so wq and wk are scaled as whisper-tiny's
CARD_VS_CPU_ZOO = (("kimi-k2-1t-a32b", 1, 2, 128, True, True, 16),
                   ("qwen2-vl-2b", 2, 1, 1088, True, True, None),
                   ("phi3-medium-14b", 1, 2, 128, True, True, None))


def phase_train_card_vs_cpu(runs=CARD_VS_CPU_DENSE, phase: int = 33) -> dict:
    """One float32 train step on the card and on the CPU from the same
    weights and batch (the config's optimizer at lr 1e-3), per entry of
    ``runs``: in phase 33 qwen3-32b at full width, depth 1, b = 2, s = 128,
    one microbatch, and whisper-tiny at full width and depth (b = 2, s = 64
    against its 1500 frames); in phase 36 mamba2-2.7b and zamba2-2.7b
    (``CARD_VS_CPU_SSM``), through both SSD kernels and, for zamba2, both
    attention kernels; in phase 41 kimi-k2-1t-a32b under Adafactor (its
    routing equal on both devices), qwen2-vl-2b with images and phi3-medium-14b
    (``CARD_VS_CPU_ZOO``); each run's launches against the reckoning.
    Checked: the loss and
    grad norm within a relative 1e-4; every gradient tensor the optimizer
    is given within a relative Frobenius 1e-3 of the CPU's (float32 sums in
    other orders, the attention backward kernel against autograd through
    the plain version); every updated weight within 2.2 lr of the CPU's.
    That last bound is all a weight allows: AdamW's first step moves an
    element by lr g / (|g| + eps) (plus the decay), so an element whose
    gradient lies within the two devices' rounding of zero, or near eps,
    may land anywhere in 2 lr (Adafactor's moves it by lr g / rms, which
    such a g leaves near 0); the share of elements beyond 1e-5 of their
    tensor's magnitude is logged.

    whisper-tiny is checked with its query and key projections scaled to a
    fan-in of d_model (std 1/sqrt(384), as a (d, h hd) projection has): the
    reference's init takes their fan-in from the head count, and its
    attention logits (std 60-130, no qk-norm) make a float32 step
    ill-conditioned, as phase 29 found for the forward (the card and the
    CPU then differ by a few tenths of a percent in the loss and by tens of
    percent in the grad norm).  That unscaled step is logged, unchecked."""
    import torch

    free_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products on the card
    torch.backends.cudnn.allow_tf32 = False
    free = subprocess.run(["free", "-g"], capture_output=True, text=True).stdout.split("\n")
    log(f"[{phase}] host memory (free -g): {' | '.join(line.strip() for line in free[:2])}")
    launches: dict = {}
    lr = 1e-3
    for arch, depth, b, s, rescale, checked, experts in runs:
        cfg = _model_cfg(arch, depth, experts, dtype="float32", microbatches=1)
        r = _card_vs_cpu_step(cfg, b, s, lr, rescale_qk=rescale)
        hc, hp = r["card"], r["cpu"]
        fwd, bwd = _attn_calls_per_step(cfg)
        sfwd, sbwd = _ssd_calls_per_step(cfg)
        counts = r["launches"]
        want = {"flash_attention_kernel": fwd, "flash_attention_bwd_kernel": bwd,
                "ssd_intra_chunk_kernel": sfwd, "ssd_intra_chunk_bwd_kernel": sbwd,
                "ssd_intra_chunk_bwd_bf16_kernel": 0}
        check(counts == want, f"{arch}: launches {counts}, expected {want}")
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
        d_loss = abs(hc["loss"] - hp["loss"]) / abs(hp["loss"])
        d_norm = abs(hc["grad_norm"] - hp["grad_norm"]) / abs(hp["grad_norm"])
        label = (f"{arch}{'' if depth is None else f' depth {depth}'}"
                 f"{'' if experts is None else f', {experts} experts'}"
                 f"{', wq and wk at fan-in d_model' if rescale else ''} float32, {cfg.optimizer}, "
                 f"{b} x {s} tokens")
        n_cpu, n_card, flips = r["routes"]
        if cfg.moe is not None:
            log(f"    routing: {n_cpu} MoE calls on the CPU, {n_card} on the card (the forward "
                f"and its recompute); calls with a token routed otherwise on the card: {flips}")
            check(n_cpu == n_card > 0 and not flips,
                  f"{label}: the routing differs between the card and the CPU: {flips}")
        log(f"    {label}{'' if checked else ' (logged, not checked)'}: loss card "
            f"{hc['loss']:.6f} / CPU {hp['loss']:.6f} (relative {d_loss:.3g}), grad norm "
            f"{hc['grad_norm']:.6f} / {hp['grad_norm']:.6f} ({d_norm:.3g}); gradients: worst "
            f"relative Frobenius {r['grad']:.3g} ({r['grad_worst']}); updated weights: at most "
            f"{r['far']:.3g} apart (lr {lr}), at most {r['share']:.3g} of a tensor's elements "
            f"beyond 1e-5 of its magnitude ({r['worst']}); card {r['t_card']:.2f} s, CPU "
            f"{r['t_cpu']:.2f} s; launches {counts}")
        if checked:
            check(d_loss <= 1e-4 and d_norm <= 1e-4,
                  f"{label}: card loss {hc['loss']} / grad norm {hc['grad_norm']} against the "
                  f"CPU's {hp['loss']} / {hp['grad_norm']}")
            check(r["grad"] <= 1e-3, f"{label}: the gradient of {r['grad_worst']} is "
                  f"{r['grad']:.3g} (relative Frobenius) from the CPU's")
            check(r["far"] <= 2.2 * lr, f"{label}: updated {r['worst']} is {r['far']:.3g} from "
                  f"the CPU's, beyond 2.2 lr")
        free_device()
    return launches

def phase_train_ssm(arch: str, phase: int, steps: int = 6, seq: int = 1024, batch: int = 8,
                    depth: int | None = None) -> dict:
    """``Trainer`` on an ssm or hybrid config (mamba2-2.7b: 64 Mamba2 layers;
    zamba2-2.7b: 54 and the shared attention block at 9 stages) at full
    width, bf16, the config's optimizer, remat and microbatches as the
    launcher sets them, ``SyntheticLM`` at seq 1024 and global batch 8,
    ``steps`` steps: per-step loss, grad norm, lr and time, each finite;
    the median step and tokens/s; peak memory against the reckoning (16
    bytes a parameter, 4 fp32 copies of a microbatch's logits and the
    checkpointed layers' or stages' bf16 inputs; 8 GiB allowed); the SSD
    kernels' (and the hybrid's attention kernels') launches per step
    against ``_ssd_calls_per_step``/``_attn_calls_per_step``; then a profile
    of one more step with the SSD backward's share of it."""
    import torch

    from repro_torch.train import SPAN_GRADS, SPAN_OPTIMIZER

    free_device()
    cfg = _model_cfg(arch, depth)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = _trainer(cfg, steps, seq, batch)  # the CUDA device: no device argument
    tr.init(0)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tr.state["params"].parameters())
    state_bytes = torch.cuda.memory_allocated()
    log(f"[{phase}] {arch} training, full width, depth {cfg.n_layers}: {n / 1e9:.3f} B "
        f"parameters, weights and {cfg.optimizer} state {state_bytes / 2**30:.2f} GiB, made in "
        f"{time.perf_counter() - t0:.2f} s; remat {cfg.remat}, {cfg.microbatches} "
        f"microbatch(es), chunk {cfg.ssm.chunk}, global batch {batch} x {seq} tokens")
    _reset_train_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = tr.train(steps, log_every=0)
    wall = time.perf_counter() - t0
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    for h in hist:
        log(f"    step {h['step']}: loss {h['loss']:.4f}, grad norm {h['grad_norm']:.4f}, lr "
            f"{h['lr']:.3g}, {h['time_s'] * 1e3:.1f} ms")
    check(all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist),
          f"an {arch} loss or grad norm is not finite")
    fwd, bwd = _attn_calls_per_step(cfg)
    sfwd, sbwd = _ssd_calls_per_step(cfg)
    want = {"flash_attention_kernel": steps * fwd, "flash_attention_bwd_kernel": steps * bwd,
            "ssd_intra_chunk_kernel": steps * sfwd, "ssd_intra_chunk_bwd_kernel": 0,
            "ssd_intra_chunk_bwd_bf16_kernel": steps * sbwd}
    check(launches == want, f"{arch} training launches {launches}, expected {want}")
    med = float(np.median([h["time_s"] for h in hist[1:]]))
    vp = tr.state["params"]["head"].shape[-1]  # the padded vocabulary
    mb_tokens = batch // cfg.microbatches * seq
    # the remat segments' inputs: a layer each (ssm), a stage each (hybrid)
    saved = cfg.n_layers // (cfg.shared_attn_every if cfg.family == "hybrid" else 1)
    reckoned = 16 * n + 4 * 4 * mb_tokens * vp + saved * mb_tokens * cfg.d_model * 2
    log(f"    {steps} steps in {wall:.2f} s; median step (steps 1-{steps - 1}) {med * 1e3:.1f} "
        f"ms: {batch * seq / med:.0f} tokens/s; peak device memory {peak / 2**30:.2f} GiB "
        f"(reckoned {reckoned / 2**30:.2f} GiB: 16 bytes x {n / 1e9:.3f} B parameters + 4 fp32 "
        f"copies of a microbatch's logits ({mb_tokens} x {vp}) + {saved} checkpointed bf16 "
        f"inputs); launches {launches}, per step SSD forward {sfwd}, backward {sbwd}, "
        f"attention forward {fwd}, backward {bwd}; with the CUDA-core SSD backward "
        f"{SSM_STEP_MS_BEFORE[arch]} ms a step in PERF.md (not measured in this run), "
        f"{SSM_STEP_MS_BEFORE[arch] - med * 1e3:.1f} ms more")
    check(peak <= reckoned + 8 * 2**30,
          f"peak device memory {peak / 2**30:.2f} GiB exceeds the reckoning "
          f"{reckoned / 2**30:.2f} GiB by more than 8 GiB")
    _, wall, kms = profile_run(lambda: tr.train(1, log_every=0), f"one {arch} train step",
                               top=12, spans=(SPAN_GRADS, SPAN_OPTIMIZER))
    ssd_bwd = sum(kms[name] for name in SSD_BWD_BF16_KERNELS)
    attn_bwd = sum(kms[name] for name in BWD_BF16_KERNELS)
    log(f"    the SSD backward in the profiled step: {ssd_bwd:.2f} ms of {wall * 1e3:.1f} ms "
        f"({100 * ssd_bwd / (wall * 1e3):.1f}%; "
        + ", ".join(f"{name} {kms[name]:.2f} ms ({kms[name] / sbwd:.4f} a call)"
                    for name in SSD_BWD_BF16_KERNELS)
        + f" over {sbwd} calls); the SSD "
        f"forward {kms['ssd_intra_chunk_kernel']:.2f} ms over {sfwd}"
        + (f"; the attention backward {attn_bwd:.2f} ms, forward "
           f"{kms['flash_attention_kernel']:.2f} ms" if fwd else ""))
    del tr
    _ssd_bwd_plain_gap(cfg, steps, seq, batch, STEP0_GAP_TOL[arch])
    return launches


def phase_restart(arch: str, phase: int, depth: int, steps: int = 4, every: int = 2,
                  seq: int = 1024, batch: int = 8, experts: int | None = None) -> dict:
    """``arch`` at full width, depth ``depth`` (and ``experts`` experts if
    given), bf16, its config's optimizer, remat and microbatches: ``steps``
    steps uninterrupted, then a run that crashes at step ``every`` after its
    checkpoint there and a fresh ``Trainer`` that restores it and trains
    on, bit for bit against the uninterrupted run (``_restart_matches``):
    the determinism of the path's kernels and ops end to end (the SSD and
    attention backward kernels, an MoE layer's dispatch and combine).  The
    uninterrupted run's launches against the reckoning."""
    import shutil
    import tempfile

    free_device()
    cfg = _model_cfg(arch, depth, experts)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        _reset_train_counts()
        a = _trainer(cfg, steps, seq, batch)
        a.init(0)
        t0 = time.perf_counter()
        hist_a = a.train(steps, log_every=0)
        wall = time.perf_counter() - t0
        launches = _train_counts()
        fwd, bwd = _attn_calls_per_step(cfg)
        sfwd, sbwd = _ssd_calls_per_step(cfg)
        want = {"flash_attention_kernel": steps * fwd, "flash_attention_bwd_kernel": steps * bwd,
                "ssd_intra_chunk_kernel": steps * sfwd, "ssd_intra_chunk_bwd_kernel": 0,
                "ssd_intra_chunk_bwd_bf16_kernel": steps * sbwd}
        check(launches == want, f"{arch} at depth {depth}: launches {launches}, expected {want}")
        check(all(np.isfinite(h["loss"]) for h in hist_a), f"an {arch} loss is not finite")
        cut = "" if experts is None else f", {experts} experts"
        log(f"[{phase}] {arch} at full width, depth {depth}{cut}, bf16, {cfg.optimizer}, global "
            f"batch {batch} x {seq} tokens, {steps} steps in {wall:.2f} s: losses "
            f"{[round(h['loss'], 4) for h in hist_a]}; launches {launches}")
        _restart_matches(cfg, a, hist_a, steps, seq, batch, every, os.path.join(root, "b"))
        del a
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the step-0 check's tolerance on the grad norms, by config: how far the
# step moves when the SSD backward's outputs carry fp32-rounding-sized
# noise (1 + 1e-7 N(0, 1), three seeds; benchmarks/torch_ssd_bwd_step0.py,
# PERF.md section 6, on an NVIDIA H100 80GB HBM3 at 700 W): mamba2-2.7b's
# grad norm 3.7e-6 to 2.2e-5, zamba2-2.7b's 7.1e-4 to 1.16e-3 (its
# backward grows the gradient some 3e7-fold from the top Mamba2 layers to
# the bottom, and amplifies such differences)
STEP0_GAP_TOL = {"mamba2-2.7b": 1e-3, "zamba2-2.7b": 3e-3}


def _ssd_bwd_plain_gap(cfg, steps: int, seq: int, batch: int, tol: float) -> None:
    """Step 0 of a training phase's run again, from the same weights and
    batch, once through the SSD backward kernel and once with
    ``ssd_intra_chunk_bwd_plain`` on the card in its place: the forward is
    the same, so the losses must be equal; the gradients differ by the
    kernel's order of summation and its bf16 roundings of dx, dB and dC
    only, so the grad norms must agree within ``tol`` (``STEP0_GAP_TOL``)."""
    from repro_torch.kernels import ssd_scan as ssd

    hist = []
    for plain in (False, True):
        free_device()
        tr = _trainer(cfg, steps, seq, batch)
        tr.init(0)
        kernel = ssd.ssd_intra_chunk_bwd
        if plain:
            ssd.ssd_intra_chunk_bwd = ssd.ssd_intra_chunk_bwd_plain
        try:
            hist.append(tr.train(1, log_every=0)[0])
        finally:
            ssd.ssd_intra_chunk_bwd = kernel
        del tr
    (hk, hp), gap = hist, abs(hist[0]["grad_norm"] - hist[1]["grad_norm"]) / hist[1]["grad_norm"]
    log(f"    step 0 with the SSD backward kernel / with ssd_intra_chunk_bwd_plain on the card: "
        f"loss {hk['loss']:.6f} / {hp['loss']:.6f}, grad norm {hk['grad_norm']:.6f} / "
        f"{hp['grad_norm']:.6f} (relative {gap:.3g}, tol {tol:g})")
    check(hk["loss"] == hp["loss"] and gap <= tol,
          f"{cfg.name}: the SSD backward kernel's step 0 differs from the plain backward's")


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

    last = [t_start]

    def elapsed(phases: str) -> None:
        now = time.perf_counter()
        log(f"    phases {phases} done in {now - last[0]:.1f} s, {now - t_start:.1f} s since the "
            f"start")
        last[0] = now

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
    busy, wall, _ = profile_run(lambda: step4.extend(
        [phase_layout_remesh(g8), phase_collectives(), phase_paper_scripts()]), "phases 22-24")
    invariants += step4
    log(f"    phases 22-24: the card idle {100 * (1 - busy / wall):.2f}% of {wall:.1f} s "
        f"(torch.profiler, this process; phase 23's NCCL rank, a process of its own, "
        f"spent {NCCL_MS[0]:.2f} ms in its calls on its host clock, outside the trace)")
    elapsed("22-24")
    # the model zoo's other families (phases 25-28) through the attention
    # kernel, then each on the card against the CPU (phase 29)
    served.append(phase_serve("grok-1-314b", 25, depth=6))
    served.append(phase_serve("kimi-k2-1t-a32b", 26, depth=2))
    elapsed("25-26")
    served.append(phase_generate("qwen2-vl-2b", 27, prompt_len=64, max_new=32, max_seq=1120))
    # text only through the engine, as the reference's engine serves it
    served.append(phase_serve("qwen2-vl-2b", 27, requests=4, prompt_len=64, max_seq=128))
    served.append(phase_generate("whisper-tiny", 28, prompt_len=4, max_new=64, max_seq=128))
    elapsed("27-28")
    phase_model_card_vs_cpu("qwen2-vl-2b", 29, depth=2, prompt_len=64, forced=True)
    phase_model_card_vs_cpu("whisper-tiny", 29, depth=4, prompt_len=4, forced=True)
    phase_model_card_vs_cpu("kimi-k2-1t-a32b", 29, depth=1, forced=True, experts=16)
    elapsed("29")
    # training: the attention backward kernel (phase 30), then the main
    # training path (31), a restart from a checkpoint (32) and card == CPU (33)
    kernels += [phase_flash_bwd(), *phase_ssd_bwd()]
    elapsed("30")
    trained = [phase_train("qwen3-32b", 31, depth=2, steps=8), phase_train_whisper(),
               phase_train_card_vs_cpu()]
    elapsed("31-33")
    # the ssm and hybrid families train through both SSD kernels (34-35),
    # then one float32 step of each, card against CPU (36)
    trained.append(phase_train_ssm("mamba2-2.7b", 34))
    trained.append(phase_restart("mamba2-2.7b", 34, depth=2))
    elapsed("34")
    trained.append(phase_train_ssm("zamba2-2.7b", 35))
    elapsed("35")
    trained.append(phase_train_card_vs_cpu(CARD_VS_CPU_SSM, phase=36))
    elapsed("36")
    # the rest of the zoo trains through the attention kernels: the moe
    # family under Adafactor (37-38), the vlm with its images (39) and a
    # dense config under "dots" with padded heads, also served (40); the
    # MoE and vlm restarts bit for bit; one float32 step of each, card
    # against CPU (41); zamba2's restart at two stages (42)
    trained.append(phase_train("grok-1-314b", 37, depth=1))
    elapsed("37")
    trained.append(phase_train("kimi-k2-1t-a32b", 38, depth=1, experts=16))
    trained.append(phase_restart("kimi-k2-1t-a32b", 38, depth=1, experts=16))
    elapsed("38")
    trained.append(phase_train("qwen2-vl-2b", 39, seq=1088))
    trained.append(phase_restart("qwen2-vl-2b", 39, depth=2, seq=1088))
    elapsed("39")
    served.append(phase_serve("phi3-medium-14b", 40))
    phase_model_card_vs_cpu("phi3-medium-14b", 40, depth=2, forced=True)
    trained.append(phase_train("phi3-medium-14b", 40, depth=4))
    elapsed("40")
    trained.append(phase_train_card_vs_cpu(CARD_VS_CPU_ZOO, phase=41))
    elapsed("41")
    trained.append(phase_restart("zamba2-2.7b", 42, depth=12))
    elapsed("42")
    log(f"    launches on the invariants' paths: Table 1 {invariants[0]}, "
        f"whole graph {invariants[1]}, 256-node suite {invariants[2]}, "
        f"layout and remesh {invariants[3]}, collectives {invariants[4]}, "
        f"tables and figures {invariants[5]}")
    for run in invariants:
        launches = {name: launches[name] + run[name] for name in launches}
    log(f"    launches on the serving paths: zamba2 {served[0]}, qwen3 {served[1]}, "
        f"mamba2 {served[2]}, grok {served[3]}, kimi {served[4]}, qwen2-vl {served[5]} and "
        f"as text {served[6]}, whisper {served[7]}, phi3 {served[8]}")
    launches.update({name: sum(run[name] for run in served) for name in served[0]})
    log(f"    launches on the training paths: qwen3 {trained[0]}, whisper {trained[1]}, "
        f"card against CPU {trained[2]}, mamba2 {trained[3]} and its restart {trained[4]}, "
        f"zamba2 {trained[5]}, card against CPU (ssm, hybrid) {trained[6]}, grok {trained[7]}, "
        f"kimi {trained[8]} and its restart {trained[9]}, qwen2-vl {trained[10]} and its "
        f"restart {trained[11]}, phi3 {trained[12]}, card against CPU (moe, vlm, dense) "
        f"{trained[13]}, zamba2's restart {trained[14]}")
    for name in trained[0]:
        launches[name] = launches.get(name, 0) + sum(run[name] for run in trained)
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
