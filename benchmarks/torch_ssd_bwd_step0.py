#!/usr/bin/env python3
"""How far one bf16 training step of mamba2-2.7b and zamba2-2.7b (full
width and depth, as ``chip_smoke.py`` phases 34-35 train them) moves when
the SSD backward is computed another way, on one NVIDIA GPU.

Run from the root of a checkout:  python3 benchmarks/torch_ssd_bwd_step0.py

Step 0 from the same seeded weights and batch, each way in a fresh
``Trainer``: the backward kernel twice (the path must be deterministic),
``ssd_intra_chunk_bwd_plain`` in fp32 (what the CPU runs), the same in
float64 (results cast back to the operands' dtypes), and the fp32 plain
version with every output multiplied by 1 + 1e-7 N(0, 1), three seeds:
noise the size of fp32 rounding.  The forward is the same in all, so the
losses are equal; the grad norms (before the clip) show how far the step's
gradient moves with each.  That spread is the noise floor of chip_smoke's
step-0 check (``STEP0_GAP_TOL``): an ill-conditioned backward amplifies
rounding-sized differences of its inputs.  For the kernel's and the fp32
plain version's steps every gradient tensor is also kept (in fp32 on the
host, about 12 GB a step) and compared: the tensors furthest apart
(relative Frobenius) and the largest and smallest gradient norms.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

NOISE = 1e-7  # fp32's unit roundoff is 6e-8
SEEDS = (0, 1, 2)


def plain64(x, dt, A, B, C, gy, gst, chunk):
    """The plain backward in float64, cast back to the operands' dtypes."""
    from repro_torch.kernels import ssd_scan as ssd

    grads = ssd.ssd_intra_chunk_bwd_plain(*(t.double() for t in (x, dt, A, B, C, gy, gst)),
                                          chunk)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (x, dt, A, B, C)))


def noisy(seed: int):
    """The fp32 plain backward with each output times 1 + NOISE N(0, 1)
    before it is cast to its operand's dtype."""
    import torch

    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def bwd(x, dt, A, B, C, gy, gst, chunk):
        grads = ssd.ssd_intra_chunk_bwd_plain(x.float(), dt, A, B.float(), C.float(), gy, gst,
                                              chunk)
        return tuple((g * (1 + NOISE * torch.randn(g.shape, generator=gen, device=g.device)))
                     .to(t.dtype) for g, t in zip(grads, (x, dt, A, B, C)))
    return bwd


def step0(cfg, bwd, keep: list | None = None) -> dict:
    """Step 0 of a fresh ``Trainer`` (seq 1024, global batch 8), with
    ``bwd`` in place of ``ssd_intra_chunk_bwd`` unless it is None; with
    ``keep``, the gradient tensors (fp32, on the host) and their leaves'
    names are appended to it."""
    import chip_smoke as cs
    from repro_torch.convert import reference_leaves
    from repro_torch.kernels import ssd_scan as ssd

    cs.free_device()
    tr = cs._trainer(cfg, 6, 1024, 8)
    tr.init(0)
    seen = cs._recording(tr) if keep is not None else None
    kernel = ssd.ssd_intra_chunk_bwd
    if bwd is not None:
        ssd.ssd_intra_chunk_bwd = bwd
    try:
        hist = tr.train(1, log_every=0)[0]
    finally:
        ssd.ssd_intra_chunk_bwd = kernel
    if keep is not None:
        names = [n for leaf in reference_leaves(cfg, tr.state["params"])
                 for n in [leaf.path] * len(leaf.tensors)]
        keep.append((names, seen[0]))
    return hist


def compare(kept) -> None:
    """The kernel's gradient tensors against the fp32 plain version's."""
    import chip_smoke as cs

    (names, gk), (_, gp) = kept
    far = sorted(((cs._rel_fro(a, b), i, n) for i, (n, a, b) in enumerate(zip(names, gk, gp))),
                 reverse=True)
    cs.log("    furthest apart, kernel against the fp32 plain (relative Frobenius): "
           + ", ".join(f"#{i} {n} {d:.3g}" for d, i, n in far[:5]))
    norms = sorted((float(g.norm()), i, n) for i, (n, g) in enumerate(zip(names, gk)))
    cs.log("    the kernel step's smallest gradient norms: "
           + ", ".join(f"#{i} {n} {v:.4g}" for v, i, n in norms[:3])
           + "; largest: " + ", ".join(f"#{i} {n} {v:.4g}" for v, i, n in norms[-3:]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_ssd_bwd_step0: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan as ssd

    t0 = time.perf_counter()
    cs.phase_device()
    cs.phase_build()
    for arch in ("mamba2-2.7b", "zamba2-2.7b"):
        cfg = cs._model_cfg(arch)
        ways = [("kernel", None), ("kernel again", None),
                ("plain fp32", ssd.ssd_intra_chunk_bwd_plain), ("plain float64", plain64)]
        ways += [(f"plain fp32, noise seed {s}", noisy(s)) for s in SEEDS]
        kept: list = []
        runs = {name: step0(cfg, bwd, kept if name in ("kernel", "plain fp32") else None)
                for name, bwd in ways}
        base, exact = runs["plain fp32"]["grad_norm"], runs["plain float64"]["grad_norm"]
        cs.log(f"{arch}, step 0 (seconds since the start: {time.perf_counter() - t0:.1f}):")
        for name, h in runs.items():
            cs.log(f"    {name:28s} loss {h['loss']:.6f}, grad norm {h['grad_norm']:.6f}: "
                   f"{abs(h['grad_norm'] - base) / base:.3g} from the fp32 plain's, "
                   f"{abs(h['grad_norm'] - exact) / exact:.3g} from the float64 plain's")
        cs.check(len({h["loss"] for h in runs.values()}) == 1, f"{arch}: the losses differ")
        cs.check(runs["kernel"]["grad_norm"] == runs["kernel again"]["grad_norm"],
                 f"{arch}: two kernel steps differ")
        compare(kept)
        del kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
