"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
(the port's copy of ``repro.launch.train``).

CPU-scale configs by default (reduced); ``--full`` selects the real config.
Runs on the CUDA device unless ``--device cpu``.  The reference's
``--use-pallas`` has no counterpart: the port's attention always runs
``flash_attention_kernel`` on the card (and its backward kernel), and the
kernels' plain versions on the CPU.  Checkpointed, restartable loop.
"""
from __future__ import annotations

import argparse

from ..configs.base import ARCH_IDS, get_config, reduced_config
from ..data import DataConfig, SyntheticLM
from ..models import build_model
from ..optim import make_optimizer
from ..train import Trainer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", choices=ARCH_IDS, default="qwen3-32b")
    p.add_argument("--full", action="store_true", help="full (non-reduced) config")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="'cpu' for the kernels' plain versions (default: the CUDA device)")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg)
    model = build_model(cfg, device=args.device)
    opt = make_optimizer(cfg.optimizer, lr=args.lr, total_steps=args.steps,
                         warmup=max(args.steps // 20, 1))
    data = SyntheticLM(cfg, DataConfig(seq_len=args.seq, global_batch=args.batch, seed=args.seed))
    tr = Trainer(model=model, opt=opt, data=data, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every)
    if args.resume and tr.restore():
        print(f"resumed at step {int(tr.state['step'])}")
    else:
        tr.init(args.seed)
    hist = tr.train(args.steps)
    print(f"final loss {hist[-1]['loss']:.4f} | stragglers {tr.stragglers} | "
          f"median step {sorted(h['time_s'] for h in hist)[len(hist)//2]*1e3:.0f} ms")
    if tr.ckpt_dir:
        tr.save()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
