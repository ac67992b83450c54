"""Batched serving engine: prefill/decode steps and a continuous batcher
(the port's copy of ``repro.serve.engine``).

Behaviour is the reference's: prompts of one wave are left-padded with
token 0 to a common length and prefilled together with no padding mask; a
lane is refilled only by a new wave (``_merge_cache`` raises on a refill).
Everything runs under ``torch.inference_mode()``.

Sampling: greedy (argmax, first maximum on ties, as ``jnp.argmax``) or
temperature, over the true vocab (padded logits are cut off).  Temperature
sampling draws from a ``torch.Generator`` seeded from ``seed`` and does not
reproduce ``jax.random.categorical``'s draws.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models.zoo import Model

__all__ = ["DecodeParams", "make_serve_steps", "ServingEngine", "Request"]


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    temperature: float = 0.0
    max_new_tokens: int = 32


def make_serve_steps(model: Model, max_seq: int):
    """(prefill_fn, decode_fn) over the model's device."""

    def prefill_fn(params, batch):
        return model.prefill(params, batch, max_seq)

    def decode_fn(params, tokens, cache):
        return model.decode_step(params, tokens, cache)

    return prefill_fn, decode_fn


def _sample(logits: torch.Tensor, vocab: int, temperature: float,
            gen: torch.Generator) -> np.ndarray:
    logits = logits[:, -1, :vocab].float()
    if temperature <= 0.0:
        nxt = torch.argmax(logits, dim=-1)
    else:
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
    return nxt.to(torch.int32).cpu().numpy()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (s,) int32
    max_new_tokens: int = 32
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_first: float | None = None
    t_done: float | None = None


class ServingEngine:
    """Continuous batcher over fixed decode slots.

    Requests taken together are prefilled together; each then owns a batch
    lane of the decode step until completion.  The first prefill's cache
    becomes the slot cache, so it must fill every slot (lane count =
    ``slots``).
    """

    def __init__(self, model: Model, params, max_seq: int, slots: int = 4,
                 decode: DecodeParams = DecodeParams(), seed: int = 0):
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.slots = slots
        self.dp = decode
        self.gen = torch.Generator(device=model.device).manual_seed(seed)
        self.prefill_fn, self.decode_fn = make_serve_steps(model, max_seq)
        self.queue: list[Request] = []
        self.lanes: list[Request | None] = [None] * slots
        self.cache = None
        self.lane_tokens = np.zeros((slots, 1), np.int32)
        self.lane_budget = np.zeros((slots,), np.int64)

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    # ------------------------------------------------------------------
    def _prefill_into_lanes(self) -> None:
        free = [i for i, lane in enumerate(self.lanes) if lane is None]
        if not free or not self.queue:
            return
        take = self.queue[: len(free)]
        del self.queue[: len(take)]
        # pad prompts to a common length (right-aligned batch prefill)
        s = max(len(r.prompt) for r in take)
        toks = np.zeros((len(take), s), np.int32)
        for i, r in enumerate(take):
            toks[i, s - len(r.prompt):] = r.prompt  # left-pad with token 0
        logits, cache = self.prefill_fn(self.params, {"tokens": toks})
        nxt = _sample(logits, self.model.cfg.vocab, self.dp.temperature, self.gen)
        now = time.perf_counter()
        for i, r in enumerate(take):
            lane = free[i]
            self.lanes[lane] = r
            r.t_first = now
            r.out_tokens.append(int(nxt[i]))
            self.lane_tokens[lane, 0] = nxt[i]
            self.lane_budget[lane] = r.max_new_tokens - 1
        self._merge_cache(cache, free[: len(take)])

    def _merge_cache(self, new_cache: dict, lanes: list[int]) -> None:
        if self.cache is None:
            self.cache = new_cache
            return
        raise NotImplementedError(
            "incremental lane refill requires cache surgery; use slots == first batch size")

    # ------------------------------------------------------------------
    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Run until queue and lanes drain.  Returns completed requests."""
        done: list[Request] = []
        self._prefill_into_lanes()
        steps = 0
        while any(lane is not None for lane in self.lanes) and steps < max_steps:
            steps += 1
            toks = self.lane_tokens[: self._n_active()]
            logits, self.cache = self.decode_fn(self.params, toks, self.cache)
            nxt = _sample(logits, self.model.cfg.vocab, self.dp.temperature, self.gen)
            now = time.perf_counter()
            for lane, r in enumerate(self.lanes):
                if r is None or lane >= len(nxt):
                    continue
                r.out_tokens.append(int(nxt[lane]))
                self.lane_tokens[lane, 0] = nxt[lane]
                self.lane_budget[lane] -= 1
                if self.lane_budget[lane] <= 0:
                    r.done = True
                    r.t_done = now
                    done.append(r)
                    self.lanes[lane] = None
        return done

    def _n_active(self) -> int:
        return self.lane_tokens.shape[0]

    # ------------------------------------------------------------------
    def stats(self, reqs: list[Request]) -> dict:
        ttft = [r.t_first - r.t_submit for r in reqs if r.t_first]
        lat = [r.t_done - r.t_submit for r in reqs if r.t_done]
        ntok = sum(len(r.out_tokens) for r in reqs)
        span = max((r.t_done or 0) for r in reqs) - min(r.t_submit for r in reqs) if reqs else 0
        return {
            "requests": len(reqs),
            "tokens": ntok,
            "ttft_mean_s": float(np.mean(ttft)) if ttft else None,
            "latency_mean_s": float(np.mean(lat)) if lat else None,
            "throughput_tok_s": ntok / span if span else None,
        }
