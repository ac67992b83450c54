"""Uniform model API (the port's counterpart of ``repro.models.zoo``), for
the families the port runs (``hybrid``):

    model = build_model(cfg, device=...)
    params = model.init(seed)                      -> nn.Module on the device
    cache = model.init_cache(batch, max_seq)
    logits, cache = model.prefill(params, batch, max_seq)
    logits, cache = model.decode_step(params, tokens, cache)

``device=None`` is the CUDA device and raises where there is none;
``"cpu"`` runs the kernels' plain versions.  Any other family raises
``NotImplementedError`` (ROADMAP, Queue 1), as do loss and training.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import PORTED_FAMILIES, ArchConfig
from ..device import resolve_device
from . import hybrid

__all__ = ["Model", "build_model"]


def _tokens(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device=device, dtype=torch.int64)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: torch.device

    def init(self, seed: int = 0) -> hybrid.HybridLM:
        """Weights drawn from ``torch.Generator(device).manual_seed(seed)``
        with the reference's std rules (not the reference's numbers)."""
        return hybrid.init_hybrid(self.cfg, seed, self.device)

    def init_cache(self, batch: int, max_seq: int) -> dict:
        return hybrid.hybrid_init_cache(self.cfg, batch, max_seq, device=self.device)

    @torch.inference_mode()
    def prefill(self, params, batch: dict, max_seq: int):
        return hybrid.hybrid_prefill(params, _tokens(batch["tokens"], self.device),
                                     self.cfg, max_seq)

    @torch.inference_mode()
    def decode_step(self, params, tokens, cache: dict):
        return hybrid.hybrid_decode_step(params, _tokens(tokens, self.device), cache,
                                         self.cfg)


def build_model(cfg: ArchConfig, device=None) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ported: "
            f"{list(PORTED_FAMILIES)}); see ROADMAP.md, Queue 1")
    return Model(cfg=cfg, device=resolve_device(device))
