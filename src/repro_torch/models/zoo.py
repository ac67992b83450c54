"""Uniform model API (the port's counterpart of ``repro.models.zoo``), for
the families the port runs (``dense``, ``ssm`` and ``hybrid``):

    model = build_model(cfg, device=...)
    params = model.init(seed)                      -> nn.Module on the device
    cache = model.init_cache(batch, max_seq)
    logits, cache = model.prefill(params, batch, max_seq)
    logits, cache = model.decode_step(params, tokens, cache)

``device=None`` is the CUDA device and raises where there is none;
``"cpu"`` runs the kernels' plain versions.  Any other family raises
``NotImplementedError`` (ROADMAP, Queue 1), as do loss and training.

The SSM family (mamba2) lives here, as in the reference: a stack of Mamba2
layers between the embedding and the head, with an O(1) decode state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..configs.base import PORTED_FAMILIES, ArchConfig
from ..device import resolve_device
from . import hybrid, ssm, transformer
from .common import DTYPES, Initializer, ParamModule, rms_norm

__all__ = ["Model", "SSMLM", "build_model"]


def _tokens(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device=device, dtype=torch.int64)


# ------------------------------------------------------------------------------
# The SSM family
# ------------------------------------------------------------------------------

class SSMLM(ParamModule):
    """The SSM model's weights: ``embed`` (vocab_padded, d), ``mamba`` (a
    ModuleList of the n_layers Mamba2 layers), ``final_norm`` and ``head``
    (d, vocab_padded), named as the reference's tree with the layer axis
    unstacked (``mamba.<i>.in_proj``)."""

    def __init__(self, embed, mamba: list, final_norm, head):
        super().__init__(embed=embed, final_norm=final_norm, head=head)
        self.mamba = nn.ModuleList(mamba)


def _init_ssm(cfg: ArchConfig, seed: int, device) -> SSMLM:
    ini = Initializer(seed, DTYPES[cfg.dtype], device)
    vp = cfg.vocab_padded(transformer.TP_MULTIPLE)
    embed = ini.normal((vp, cfg.d_model), stddev=1.0)
    mamba = [ssm.MambaBlock.init(ini, cfg) for _ in range(cfg.n_layers)]
    return SSMLM(embed, mamba, ini.ones((cfg.d_model,)), ini.normal((cfg.d_model, vp)))


def _ssm_forward(params: SSMLM, tokens: torch.Tensor, cfg: ArchConfig, collect: bool = False):
    """Full-sequence forward.  Returns (x after the final norm, per-layer
    (ssm, conv) states; empty unless ``collect``)."""
    x = params["embed"][tokens]
    states = []
    for layer in params["mamba"]:
        x, st, cv = ssm.mamba_block(layer, x, cfg)
        if collect:
            states.append((st, cv))
    return rms_norm(x, params["final_norm"]), states


def _ssm_prefill(params: SSMLM, tokens: torch.Tensor, cfg: ArchConfig):
    """Returns (last-position logits (b, 1, vocab_padded), cache): the
    per-layer SSM states in fp32 and conv states in bf16, as the reference
    caches them."""
    x, states = _ssm_forward(params, tokens, cfg, collect=True)
    logits = torch.einsum("bsd,dv->bsv", x[:, -1:], params["head"])
    cache = {"ssm": torch.stack([st for st, _ in states]),
             "conv": torch.stack([cv for _, cv in states]).to(torch.bfloat16),
             "index": tokens.shape[1]}
    return logits, cache


def _ssm_decode(params: SSMLM, tokens: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One token per lane.  Updates ``cache`` in place; the conv state is read
    in the activations' dtype and stored back in the cache's (bf16), as the
    reference does."""
    x = params["embed"][tokens]
    for i, layer in enumerate(params["mamba"]):
        x, st, cv = ssm.mamba_decode_step(layer, x, cache["ssm"][i],
                                          cache["conv"][i].to(x.dtype), cfg)
        cache["ssm"][i] = st
        cache["conv"][i] = cv
    x = rms_norm(x, params["final_norm"])
    cache["index"] = int(cache["index"]) + 1
    return torch.einsum("bsd,dv->bsv", x, params["head"]), cache


# ------------------------------------------------------------------------------
# The uniform API
# ------------------------------------------------------------------------------

@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: torch.device

    def init(self, seed: int = 0) -> nn.Module:
        """Weights drawn from ``torch.Generator(device).manual_seed(seed)``
        with the reference's std rules (not the reference's numbers)."""
        f = self.cfg.family
        if f == "dense":
            return transformer.init_dense(self.cfg, seed, self.device)
        if f == "ssm":
            return _init_ssm(self.cfg, seed, self.device)
        return hybrid.init_hybrid(self.cfg, seed, self.device)

    def init_cache(self, batch: int, max_seq: int) -> dict:
        f = self.cfg.family
        if f == "dense":
            return transformer.dense_init_cache(self.cfg, batch, max_seq, device=self.device)
        if f == "ssm":
            return {**ssm.init_ssm_state(self.cfg, self.cfg.n_layers, batch, self.device),
                    "index": 0}
        return hybrid.hybrid_init_cache(self.cfg, batch, max_seq, device=self.device)

    @torch.inference_mode()
    def prefill(self, params, batch: dict, max_seq: int):
        f = self.cfg.family
        tokens = _tokens(batch["tokens"], self.device)
        if f == "dense":
            return transformer.dense_prefill(params, tokens, self.cfg, max_seq)
        if f == "ssm":
            return _ssm_prefill(params, tokens, self.cfg)
        return hybrid.hybrid_prefill(params, tokens, self.cfg, max_seq)

    @torch.inference_mode()
    def decode_step(self, params, tokens, cache: dict):
        f = self.cfg.family
        tokens = _tokens(tokens, self.device)
        if f == "dense":
            return transformer.dense_decode_step(params, tokens, cache, self.cfg)
        if f == "ssm":
            return _ssm_decode(params, tokens, cache, self.cfg)
        return hybrid.hybrid_decode_step(params, tokens, cache, self.cfg)


def build_model(cfg: ArchConfig, device=None) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ported: "
            f"{list(PORTED_FAMILIES)}); see ROADMAP.md, Queue 1")
    return Model(cfg=cfg, device=resolve_device(device))
