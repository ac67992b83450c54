"""Deterministic synthetic data pipeline with host sharding and skip-ahead:
the port's copy of ``repro.data.pipeline``.

Batch ``i`` is a pure function of ``(seed, i, host_id)``: a numpy
``Generator`` seeded by ``SeedSequence([seed, i, host_id])`` draws it, so
skip-ahead after a restore is O(1) (set the counter) and every host draws
only its own shard.  The draws are the reference's, in the same order, so
the port's batches equal the reference's bit for bit.

The token stream is learnable (not iid noise): a vocab-periodic Markov walk
with noise.

A batch is a dict of CPU tensors (the reference's arrays): ``tokens`` and
``labels`` (b, s) int32; for a vlm ``img_embeds`` (b, img_tokens, d) bf16
and ``positions`` (3, b, s) int32; for an encdec ``frames`` (b, enc_seq, d)
bf16.  The bf16 entries round the float64 draws through float32, as
``jnp.asarray(x, jnp.bfloat16)`` does with 64-bit mode off, without
``ml_dtypes``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..configs.base import ArchConfig

__all__ = ["DataConfig", "SyntheticLM", "make_batch"]


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


class SyntheticLM:
    """Deterministic counter-based synthetic LM stream."""

    def __init__(self, cfg: ArchConfig, data: DataConfig):
        if data.global_batch % data.n_hosts:
            raise ValueError(f"global_batch={data.global_batch} does not split over "
                             f"n_hosts={data.n_hosts}")
        self.cfg = cfg
        self.data = data
        self.step = 0

    # -- checkpointable state -------------------------------------------------
    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])

    # -- generation -----------------------------------------------------------
    def _tokens(self, rng: np.random.Generator, b: int, s: int) -> np.ndarray:
        v = self.cfg.vocab
        # Markov-ish: x[t] = (x[t-1]*a + c) mod v with occasional resets
        a = 31, 17
        x = np.empty((b, s + 1), np.int64)
        x[:, 0] = rng.integers(0, v, size=b)
        noise = rng.random((b, s))
        rnd = rng.integers(0, v, size=(b, s))
        for t in range(1, s + 1):
            nxt = (x[:, t - 1] * a[0] + a[1]) % v
            x[:, t] = np.where(noise[:, t - 1] < 0.1, rnd[:, t - 1], nxt)
        return x

    def batch(self, i: int | None = None) -> dict:
        """Batch ``i`` (default: internal counter), host-sharded."""
        d = self.data
        i = self.step if i is None else i
        per_host = d.global_batch // d.n_hosts
        rng = np.random.default_rng(np.random.SeedSequence([d.seed, i, d.host_id]))
        x = self._tokens(rng, per_host, d.seq_len)
        out = {
            "tokens": torch.from_numpy(x[:, :-1].astype(np.int32)),
            "labels": torch.from_numpy(x[:, 1:].astype(np.int32)),
        }
        cfg = self.cfg
        if cfg.family == "vlm":
            s_img = cfg.img_tokens
            out["tokens"] = out["tokens"][:, s_img:].contiguous()
            out["labels"] = out["labels"][:, s_img:].contiguous()
            out["img_embeds"] = _bf16(rng.normal(size=(per_host, s_img, cfg.d_model)))
            pos = np.broadcast_to(np.arange(d.seq_len, dtype=np.int32)[None, None],
                                  (3, per_host, d.seq_len))
            out["positions"] = torch.from_numpy(np.ascontiguousarray(pos))
        elif cfg.family == "encdec":
            out["frames"] = _bf16(rng.normal(size=(per_host, cfg.enc_seq, cfg.d_model)))
        if i == self.step:
            self.step += 1
        return out

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.batch()


def make_batch(cfg: ArchConfig, batch: int, seq: int, seed: int = 0) -> dict:
    """One-shot batch (tests / examples)."""
    return SyntheticLM(cfg, DataConfig(seq_len=seq, global_batch=batch, seed=seed)).batch(0)
