"""Batched serving demo on the PyTorch port: continuous batching over
decode slots with TTFT / throughput stats (deliverable b, serving flavour).

The counterpart of ``examples/serve_demo.py`` over ``repro_torch`` only,
with the reference's reduced config, waves of prompts (drawn from
``numpy.random.default_rng(0)``) and ``stats`` line.  The weights come from
``Model.init(0)``, a ``torch.Generator`` under the reference's std rules, so
the numbers are not the reference's; carried across with
``repro_torch.convert.params_from_reference``, the greedy tokens
(``--temperature 0``) are.  Temperature sampling draws from a
``torch.Generator`` and cannot reproduce ``jax.random.categorical``'s draws.

On the card (the default) the reduced dense configs serve through
``flash_attention_kernel`` at head dim 16, in the config's bf16.  The
reduced ssm and hybrid configs (SSD chunk 8, head dim 8) lie outside the
bf16 SSD kernel's domain (``kernels.ssd_scan.check_bf16_domain``): there the
prefill raises that ``ValueError``.  ``--device cpu`` runs the kernels'
plain PyTorch versions.

    python examples/torch_serve_demo.py --arch qwen3-32b [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.serve import DecodeParams, Request, ServingEngine

MAX_SEQ = 64
PROMPT_LEN = 6


def serve(model, params, requests: int = 8, slots: int = 4, max_new: int = 16,
          temperature: float = 0.7, out=print) -> tuple[list, dict]:
    """The reference example's serving loop: ``requests`` prompts in waves
    of ``slots``, the lanes and cache reset per wave, the first two
    requests of each wave printed; returns the finished requests and
    ``ServingEngine.stats`` of them."""
    rng = np.random.default_rng(0)
    eng = ServingEngine(model, params, max_seq=MAX_SEQ, slots=slots,
                        decode=DecodeParams(temperature=temperature, max_new_tokens=max_new))
    done = []
    rid = 0
    remaining = requests
    while remaining:
        wave = min(slots, remaining)
        for _ in range(wave):
            eng.submit(Request(rid=rid,
                               prompt=rng.integers(0, model.cfg.vocab, PROMPT_LEN).astype(np.int32),
                               max_new_tokens=max_new))
            rid += 1
        eng.lanes = [None] * slots
        eng.cache = None
        batch_done = eng.run()
        done += batch_done
        remaining -= wave
        for r in batch_done[:2]:
            out(f"req {r.rid}: prompt {r.prompt.tolist()} -> {r.out_tokens}")
    return done, eng.stats(done)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", choices=ARCH_IDS, default="qwen3-32b")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a CUDA device) or cpu")
    args = p.parse_args(argv)

    cfg = reduced_config(get_config(args.arch))
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    done, st = serve(model, params, args.requests, args.slots, args.max_new, args.temperature)
    print(f"\n{st['requests']} requests, {st['tokens']} tokens | "
          f"TTFT {st['ttft_mean_s']*1e3:.0f} ms | {st['throughput_tok_s']:.1f} tok/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
