"""Uniform model API (the port's counterpart of ``repro.models.zoo``) over
the six families (``dense``, ``moe``, ``vlm``, ``ssm``, ``hybrid``,
``encdec``):

    model = build_model(cfg, device=...)
    params = model.init(seed)                      -> nn.Module on the device
    cache = model.init_cache(batch, max_seq)
    logits, cache = model.prefill(params, batch, max_seq)
    logits, cache = model.decode_step(params, tokens, cache)
    loss, metrics = model.loss(params, batch)      # differentiable, for training

A batch is the reference's dict of numpy arrays or tensors: ``tokens``
(b, s); for vlm optionally ``img_embeds`` (b, img_tokens, d) and
``positions`` (3, b, img_tokens + s); for encdec ``frames``
(b, enc_seq, d), without which prefill raises ``ValueError`` (the
reference raises ``KeyError``).  A training batch adds ``labels`` (b, s).
``device=None`` is the CUDA device and raises where there is none;
``"cpu"`` runs the kernels' plain versions.  ``loss`` records autograd
(no ``inference_mode``); ``prefill`` and ``decode_step`` do not.

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
from . import encdec, hybrid, ssm, transformer
from .common import DTYPES, Initializer, ParamModule, cross_entropy_loss, remat, rms_norm

__all__ = ["Model", "SSMLM", "build_model"]


_TRANSFORMER = ("dense", "moe", "vlm")


def _tensor(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A batch entry (numpy array or tensor) on ``device``.  A numpy array is
    copied (it may be read-only); a bfloat16 one (``ml_dtypes``) goes
    through its bits."""
    if isinstance(x, np.ndarray):
        if x.dtype.name == "bfloat16":
            x = torch.from_numpy(np.array(x).view(np.uint16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)


def _tokens(x, device: torch.device) -> torch.Tensor:
    return _tensor(x, device, torch.int64)


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


def _ssm_train_logits(params: SSMLM, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Logits at every position (b, s, vocab_padded), each Mamba2 layer
    checkpointed unless ``remat`` is "none", as the reference's
    ``jax.checkpoint`` of a layer: on the card a checkpointed layer
    launches the SSD forward twice (the forward and its recompute) and the
    SSD backward kernel once per step and microbatch."""
    x = params["embed"][batch["tokens"]]
    run = remat(lambda layer, x: ssm.mamba_block(layer, x, cfg)[0],
                "none" if cfg.remat == "none" else "full")
    for layer in params["mamba"]:
        x = run(layer, x)
    x = rms_norm(x, params["final_norm"])
    return torch.einsum("bsd,dv->bsv", x, params["head"])


def _ssm_loss(params: SSMLM, batch: dict, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    return cross_entropy_loss(_ssm_train_logits(params, batch, cfg), batch["labels"], cfg.vocab)


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
        if f in _TRANSFORMER:
            return transformer.init_dense(self.cfg, seed, self.device)
        if f == "ssm":
            return _init_ssm(self.cfg, seed, self.device)
        if f == "encdec":
            return encdec.init_encdec(self.cfg, seed, self.device)
        return hybrid.init_hybrid(self.cfg, seed, self.device)

    def init_cache(self, batch: int, max_seq: int) -> dict:
        f = self.cfg.family
        if f in _TRANSFORMER:
            return transformer.dense_init_cache(self.cfg, batch, max_seq, device=self.device)
        if f == "ssm":
            return {**ssm.init_ssm_state(self.cfg, self.cfg.n_layers, batch, self.device),
                    "index": 0}
        if f == "encdec":
            return encdec.encdec_init_cache(self.cfg, batch, max_seq, device=self.device)
        return hybrid.hybrid_init_cache(self.cfg, batch, max_seq, device=self.device)

    def loss(self, params, batch: dict) -> tuple[torch.Tensor, dict]:
        """(loss, metrics) of a training batch: the differentiable fp32 mean
        cross-entropy with z-loss (plus the router's aux term for an MoE
        config) and its detached metrics.  Gradients reach the parameters
        that require them (``Trainer`` turns them on)."""
        f = self.cfg.family
        b = {name: (_tokens(v, self.device) if name in ("tokens", "labels")
                    else _tensor(v, self.device)) for name, v in batch.items()}
        if f in _TRANSFORMER:
            return transformer.dense_loss(params, b, self.cfg)
        if f == "ssm":
            return _ssm_loss(params, b, self.cfg)
        if f == "encdec":
            return encdec.encdec_loss(params, b, self.cfg)
        return hybrid.hybrid_loss(params, b, self.cfg)

    @torch.inference_mode()
    def prefill(self, params, batch: dict, max_seq: int):
        f = self.cfg.family
        tokens = _tokens(batch["tokens"], self.device)
        if f in _TRANSFORMER:
            extra = {name: _tensor(batch[name], self.device)
                     for name in ("img_embeds", "positions") if name in batch}
            return transformer.dense_prefill(params, tokens, self.cfg, max_seq, **extra)
        if f == "ssm":
            return _ssm_prefill(params, tokens, self.cfg)
        if f == "encdec":
            if "frames" not in batch:
                raise ValueError(f"{self.cfg.name}: an encdec prefill needs the batch's "
                                 f"'frames' (b, enc_seq, d_model)")
            frames = _tensor(batch["frames"], self.device)
            return encdec.encdec_prefill(params, tokens, frames, self.cfg, max_seq)
        return hybrid.hybrid_prefill(params, tokens, self.cfg, max_seq)

    @torch.inference_mode()
    def decode_step(self, params, tokens, cache: dict):
        f = self.cfg.family
        tokens = _tokens(tokens, self.device)
        if f in _TRANSFORMER:
            return transformer.dense_decode_step(params, tokens, cache, self.cfg)
        if f == "ssm":
            return _ssm_decode(params, tokens, cache, self.cfg)
        if f == "encdec":
            return encdec.encdec_decode_step(params, tokens, cache, self.cfg)
        return hybrid.hybrid_decode_step(params, tokens, cache, self.cfg)


def build_model(cfg: ArchConfig, device=None) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} (known: "
                         f"{list(PORTED_FAMILIES)})")
    return Model(cfg=cfg, device=resolve_device(device))
