"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs the continuous-batching engine on synthetic prompts (drawn from
``numpy.random.default_rng(seed)``) and seeded random weights, and reports
TTFT / latency / throughput.  ``--full`` selects the real config;
``--device cpu`` runs the kernels' plain versions (the default is the CUDA
device, and the launcher fails without one).  The default architecture is
the reference launcher's, ``qwen3-32b`` (dense); ``--arch`` takes any of the
ten: the other dense configs, ``mamba2-2.7b`` (ssm), ``zamba2-2.7b``
(hybrid), ``grok-1-314b`` and ``kimi-k2-1t-a32b`` (moe) and ``qwen2-vl-2b``
(vlm, served as text, as the reference's engine serves it).  The engine
passes only tokens to prefill, as the reference's does, so
``whisper-tiny`` (encdec, which needs frames) fails as the reference's
launcher does, here with ``ValueError`` (the reference's with
``KeyError``); drive it through ``Model.prefill``/``decode_step``.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs.base import ARCH_IDS, get_config, reduced_config
from ..models import build_model
from ..serve import DecodeParams, Request, ServingEngine


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", choices=ARCH_IDS, default="qwen3-32b")
    p.add_argument("--full", action="store_true")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--max-seq", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg)
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    rng = np.random.default_rng(args.seed)
    eng = ServingEngine(model, params, max_seq=args.max_seq, slots=args.slots,
                        decode=DecodeParams(temperature=args.temperature,
                                            max_new_tokens=args.max_new),
                        seed=args.seed)
    done = []
    remaining = args.requests
    rid = 0
    while remaining > 0:
        wave = min(args.slots, remaining)
        for _ in range(wave):
            eng.submit(Request(rid=rid,
                               prompt=rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32),
                               max_new_tokens=args.max_new))
            rid += 1
        eng.lanes = [None] * args.slots
        eng.cache = None
        done += eng.run()
        remaining -= wave
    st = eng.stats(done)
    print(f"served {st['requests']} requests, {st['tokens']} tokens | "
          f"TTFT {st['ttft_mean_s']*1e3:.0f} ms | latency {st['latency_mean_s']*1e3:.0f} ms | "
          f"{st['throughput_tok_s']:.1f} tok/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
