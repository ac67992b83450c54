"""Step 0 of a config's training, the PyTorch port against the JAX
package, float32, on the CPU: does the port's large gradient scale on the
card (zamba2-2.7b: a bf16 grad norm of 2.5-4.2 million at full depth;
qwen2-vl-2b: about 1.5e18) come from the reference's own model, or from
the port?

At full width and a cut depth (zamba2-2.7b, the default: 6 and 12, one and
two applications of the shared attention block), both packages start from
the same weights
(the reference's init, carried across by ``convert.params_from_reference``)
and take the same batch (``repro.data.make_batch``).  Printed per depth:
the loss and the global gradient norm of each, then the leaves with the
largest gradient norms, each with both packages' norms and the relative
Frobenius distance of the port's gradient from the reference's.

The reference differentiates its jnp ``ssd_chunked_ref``, whose float32
gradient of dt and A overflows to NaN at the config's chunk of 256 (cs
falls to about -200 across a chunk); ``--chunk`` sets the SSD chunk for
both packages (the function does not depend on it), so a chunk of 64 gives
the reference a finite gradient to compare with.  A vlm's batch carries
its image embeddings and M-RoPE positions (``--seq`` counts both).

``--float64`` also takes the port's step in float64 from the same weights
and batch, a witness of how far each float32 run lies from the exact
gradient: where the two float32 runs differ, it says whether the port or
the reference is off, or both by float32 rounding.

    PYTHONPATH=src JAX_PLATFORMS=cpu python benchmarks/gradscale_vs_reference.py \
        [--arch zamba2-2.7b] [--depths 6 12] [--chunk 64] [--seq 256] [--batch 1] [--float64]

It imports both packages, as the CPU tests do; the port itself imports
neither JAX nor ``repro``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import make_batch as jmake_batch  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference, reference_leaves  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def _cut(cfg, depth: int, chunk: int):
    ssm = None if cfg.ssm is None else dataclasses.replace(cfg.ssm, chunk=chunk)
    return dataclasses.replace(cfg, n_layers=depth, dtype="float32", ssm=ssm)


def step0(arch: str, depth: int, chunk: int, seq: int, batch: int, top: int,
          float64: bool = False) -> dict:
    jcfg = _cut(jget_config(arch), depth, chunk)
    cfg = _cut(get_config(arch), depth, chunk)
    t0 = time.perf_counter()
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    data = jmake_batch(jcfg, batch, seq, seed=0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, data)
    t_ref = time.perf_counter() - t0
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    params.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, jp)))
    del jp
    params.requires_grad_(True)
    t0 = time.perf_counter()
    loss, _ = m.loss(params, {k: np.asarray(v) for k, v in data.items()})
    leaves = reference_leaves(cfg, params)
    flat = [t for leaf in leaves for t in leaf.tensors]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    t_port = time.perf_counter() - t0
    ref = params_from_reference(cfg, jax.tree.map(np.asarray, jgrads))
    del jgrads
    names = dict((id(t), n) for n, t in params.named_parameters())
    rows = []
    for leaf in leaves:
        got = torch.stack([torch.zeros_like(t) if g is None else g.detach()
                           for t, g in zip(leaf.tensors, grads[:len(leaf.tensors)])])
        grads = grads[len(leaf.tensors):]
        want = torch.stack([ref[names[id(t)]] for t in leaf.tensors])
        gn, wn = float(got.double().norm()), float(want.double().norm())
        rel = float((got - want).double().norm()) / wn if wn and np.isfinite(wn) else float("nan")
        rows.append((leaf.path, gn, wn, rel))
    port_norm = float(np.sqrt(sum(r[1] ** 2 for r in rows)))
    ref_norm = float(np.sqrt(sum(r[2] ** 2 for r in rows)))
    print(f"{arch} at full width, depth {depth} ({'' if cfg.ssm is None else f'chunk {chunk}, '}"
          f"{batch} x {seq} tokens, "
          f"float32, CPU): loss port {float(loss.detach()):.6f} / reference {float(jloss):.6f}; grad "
          f"norm port {port_norm:.6g} / reference {ref_norm:.6g} (relative "
          f"{abs(port_norm - ref_norm) / ref_norm:.3g}); port {t_port:.1f} s, reference "
          f"{t_ref:.1f} s (with its compile)", flush=True)
    nonfinite = [r[0] for r in rows if not np.isfinite(r[2])]
    if nonfinite:
        print(f"    leaves whose reference gradient is not finite: {nonfinite}", flush=True)
    print(f"    the {top} leaves with the largest gradient norms (port / reference, relative "
          f"Frobenius distance):", flush=True)
    for path, gn, wn, rel in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"      {path:36s} {gn:14.6g} / {wn:14.6g}  {rel:.3g}", flush=True)
    out = {"depth": depth, "loss": (float(loss.detach()), float(jloss)),
           "grad_norm": (port_norm, ref_norm), "leaves": rows}
    if float64:
        out["float64"] = _float64_witness(cfg, m, params, data, rows, top)
    return out


def _float64_witness(cfg, m, params, data, rows, top: int) -> dict:
    """The port's step 0 again with the same weights and batch in float64:
    its loss and grad norm, and each float32 run's distance from them."""
    params = params.double()
    batch = {k: np.asarray(v) for k, v in data.items()}
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
    loss, _ = m.loss(params, batch)
    leaves = reference_leaves(cfg, params)
    grads = torch.autograd.grad(loss, [t for leaf in leaves for t in leaf.tensors],
                                allow_unused=True)
    exact = []
    for leaf in leaves:
        got = [torch.zeros_like(t) if g is None else g for t, g in zip(leaf.tensors, grads)]
        grads = grads[len(leaf.tensors):]
        exact.append(float(torch.stack(got).norm()))
    norm = float(np.sqrt(sum(e * e for e in exact)))
    port32 = float(np.sqrt(sum(r[1] ** 2 for r in rows)))
    ref32 = float(np.sqrt(sum(r[2] ** 2 for r in rows)))
    print(f"    float64 port: loss {float(loss.detach()):.9f}, grad norm {norm:.6g}; the float32 "
          f"grad norms' distance from it: port {(port32 - norm) / norm:+.3g}, reference "
          f"{(ref32 - norm) / norm:+.3g}", flush=True)
    print(f"    the {top} leaves with the largest float64 gradient norms (float64 / float32 port / "
          f"float32 reference):", flush=True)
    for e, (path, gn, wn, _) in sorted(zip(exact, rows), key=lambda r: -r[0])[:top]:
        print(f"      {path:36s} {e:14.6g} / {gn:14.6g} / {wn:14.6g}", flush=True)
    return {"loss": float(loss.detach()), "grad_norm": norm, "leaves": exact}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--depths", type=int, nargs="+", default=[6, 12])
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--float64", action="store_true",
                    help="also the port's step in float64, the exact gradient's witness")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    for depth in args.depths:
        step0(args.arch, depth, args.chunk, args.seq, args.batch, args.top, args.float64)
    return 0


if __name__ == "__main__":
    sys.exit(main())
