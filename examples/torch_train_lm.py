"""End-to-end LM training with the port: data pipeline -> model -> AdamW ->
checkpointed fault-tolerant loop, with the loss curve printed (the port's
copy of ``examples/train_lm.py``).

Presets:
    cpu   (default)  ~2M params, a few hundred steps in minutes
    100m             ~100M-param qwen3-style config (same code path)

``--mesh`` trains on a world-size-1 (1, 1, 1) ("pod", "data", "model")
mesh (DTensor weights and optimizer state placed by ``launch.specs``,
each rank's step on its local shards); without it, on one device.  Runs on
the CUDA device unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 [--device cpu] [--mesh]
"""
import argparse
import contextlib
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import local_world, make_test_mesh
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer

PRESETS = {
    "cpu": ArchConfig(name="lm-cpu", family="dense", n_layers=4, d_model=128,
                      n_heads=4, n_kv_heads=2, d_ff=512, vocab=2048, head_dim=32,
                      remat="none", optimizer="adamw"),
    "100m": ArchConfig(name="lm-100m", family="dense", n_layers=10, d_model=640,
                       n_heads=10, n_kv_heads=5, d_ff=2560, vocab=32000, head_dim=64,
                       remat="dots", optimizer="adamw"),
}


def run(args, out=print) -> list[dict]:
    """Train as the arguments say; returns the history."""
    cfg = PRESETS[args.preset]
    with contextlib.ExitStack() as stack:
        if args.mesh:
            stack.enter_context(local_world(args.device))
            model = build_model(cfg, mesh=make_test_mesh((1, 1, 1), device=args.device))
        else:
            model = build_model(cfg, device=args.device)
        ckpt_dir = args.ckpt_dir or stack.enter_context(tempfile.TemporaryDirectory())
        opt = make_optimizer("adamw", lr=args.lr, total_steps=args.steps,
                             warmup=max(args.steps // 20, 1))
        data = SyntheticLM(cfg, DataConfig(seq_len=args.seq, global_batch=args.batch, seed=0))
        tr = Trainer(model=model, opt=opt, data=data, ckpt_dir=ckpt_dir, ckpt_every=100)
        if not tr.restore():
            tr.init()
            out("fresh start")
        else:
            out(f"resumed from step {int(tr.state['step'])}")
        hist = tr.train(args.steps, log_every=25, log_fn=out)
        first = np.mean([h["loss"] for h in hist[:10]])
        last = np.mean([h["loss"] for h in hist[-10:]])
        out(f"\nloss {first:.4f} -> {last:.4f} over {len(hist)} steps "
            f"({'LEARNING' if last < first - 0.1 else 'check hyperparams'})")
        tr.save()
    return hist


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", choices=list(PRESETS), default="cpu")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (default: a temporary one)")
    p.add_argument("--mesh", action="store_true",
                   help="train on a world-size-1 (1, 1, 1) mesh")
    p.add_argument("--device", default=None,
                   help="'cpu' for the kernels' plain versions (default: the CUDA device)")
    run(p.parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
