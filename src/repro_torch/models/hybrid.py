"""Zamba2-style hybrid: a Mamba2 backbone with ONE shared attention block
applied every ``shared_attn_every`` layers, its weights reused at each
application (the port's copy of ``repro.models.hybrid``, serving path).

Layer layout for 54 layers, period 6 (9 stages):
    [6 x mamba] -> shared-attn -> [6 x mamba] -> shared-attn -> ...

Decode state: per-layer SSM and conv states plus one KV cache per stage:
each application of the shared block sees a different depth, so the caches
are distinct though the weights are shared.  The reference's ``lax.scan``
over stages and layers is a Python loop here.  Training: ``hybrid_loss``,
each stage (its Mamba layers and the shared block) checkpointed unless
``remat`` is "none", as the reference's ``jax.checkpoint`` of a stage.
It trains on the card through both kernels' backwards
(``ssd_scan.ssd_intra_chunk_bwd`` once per Mamba2 layer, the attention
backward once per stage) and on the CPU through their plain versions.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from .common import DTYPES, Initializer, ParamModule, cross_entropy_loss, remat, rms_norm
from .ssm import (MambaBlock, init_ssm_state, mamba_block, mamba_decode_step,
                  mamba_logical_axes, ssm_state_logical_axes)
from .transformer import (DenseBlock, _positions_for, dense_layer, dense_layer_decode,
                          padded_dims)

__all__ = [
    "HybridLM",
    "init_hybrid",
    "hybrid_forward",
    "hybrid_param_axes",
    "hybrid_cache_axes",
    "hybrid_init_cache",
    "hybrid_prefill",
    "hybrid_decode_step",
    "hybrid_train_logits",
    "hybrid_loss",
]


def _stages(cfg: ArchConfig) -> tuple[int, int]:
    period = cfg.shared_attn_every
    if period <= 0 or cfg.n_layers % period:
        raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of "
                         f"shared_attn_every={period}")
    return cfg.n_layers // period, period


class HybridLM(ParamModule):
    """The hybrid model's weights: ``embed`` (vocab_padded, d), ``mamba`` (a
    ModuleList of the n_layers Mamba blocks), ``shared`` (the attention +
    SwiGLU block, a ``transformer.DenseBlock``), ``final_norm`` and
    ``head`` (d, vocab_padded).  Its state dict names follow the
    reference's tree with the layer axis unstacked (``mamba.<i>.in_proj``)."""

    def __init__(self, embed, mamba: list, shared: DenseBlock, final_norm, head):
        super().__init__(embed=embed, final_norm=final_norm, head=head)
        self.mamba = nn.ModuleList(mamba)
        self.shared = shared


def init_hybrid(cfg: ArchConfig, seed: int, device) -> HybridLM:
    _, _, vp = padded_dims(cfg)
    d = cfg.d_model
    ini = Initializer(seed, DTYPES[cfg.dtype], device)
    embed = ini.normal((vp, d), stddev=1.0)
    mamba = [MambaBlock.init(ini, cfg) for _ in range(cfg.n_layers)]
    shared = DenseBlock.init(ini, cfg)
    return HybridLM(embed, mamba, shared, ini.ones((d,)), ini.normal((d, vp)))


def hybrid_forward(params: HybridLM, tokens: torch.Tensor, cfg: ArchConfig,
                   collect: bool = False):
    """Full-sequence forward.  Returns (x, per-layer (ssm, conv) states,
    per-stage shared-block (k, v)); the lists are empty unless ``collect``."""
    n_stage, period = _stages(cfg)
    x = params["embed"][tokens]
    b, seq = x.shape[:2]
    positions = _positions_for(b, seq, x.device)
    states, kvs = [], []
    for stage in range(n_stage):
        for j in range(period):
            x, st, cv = mamba_block(params["mamba"][stage * period + j], x, cfg)
            if collect:
                states.append((st, cv))
        x, kv = dense_layer(params["shared"], x, positions, cfg)
        if collect:
            kvs.append(kv)
    return x, states, kvs


def hybrid_param_axes(cfg: ArchConfig) -> dict:
    """Logical dim names of the hybrid's weights, as the reference's: the
    stacked Mamba2 layers and the one shared attention block."""
    attn = {
        "wq": ("w_embed", "w_heads", None),
        "wk": ("w_embed", "w_kv_heads", None),
        "wv": ("w_embed", "w_kv_heads", None),
        "wo": ("w_heads", None, "w_embed"),
    }
    return {
        "embed": ("w_vocab", "w_embed"),
        "mamba": mamba_logical_axes(),
        "shared": {
            "attn": attn,
            "mlp": {"w1": ("w_embed", "w_ff"), "w3": ("w_embed", "w_ff"),
                    "w2": ("w_ff", "w_embed")},
            "ln1": (None,),
            "ln2": (None,),
        },
        "final_norm": (None,),
        "head": ("w_embed", "w_vocab"),
    }


def hybrid_cache_axes() -> dict:
    return {
        **ssm_state_logical_axes(),
        "k": (None, "batch", "kv_heads", "kv_seq", None),
        "v": (None, "batch", "kv_heads", "kv_seq", None),
        "index": (),
    }


def hybrid_init_cache(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    n_stage, _ = _stages(cfg)
    _, kvp, _ = padded_dims(cfg)
    hd = cfg.resolved_head_dim
    return {
        **init_ssm_state(cfg, cfg.n_layers, batch, device),
        "k": torch.zeros((n_stage, batch, kvp, max_seq, hd), dtype=dtype, device=device),
        "v": torch.zeros((n_stage, batch, kvp, max_seq, hd), dtype=dtype, device=device),
        "index": 0,
    }


def hybrid_prefill(params: HybridLM, tokens: torch.Tensor, cfg: ArchConfig, max_seq: int):
    """A full forward that also records the SSM states and the shared KV.
    Returns (last-position logits (b, 1, vocab_padded), cache)."""
    x, states, kvs = hybrid_forward(params, tokens, cfg, collect=True)
    b, seq = tokens.shape
    if seq > max_seq:
        raise ValueError(f"prompt of {seq} tokens exceeds max_seq={max_seq}")
    x = rms_norm(x, params["final_norm"])
    logits = torch.einsum("bsd,dv->bsv", x[:, -1:], params["head"])
    k0 = kvs[0][0]
    kv_shape = (len(kvs), b, k0.shape[2], max_seq, k0.shape[3])
    cache = {
        "ssm": torch.stack([st for st, _ in states]),
        "conv": torch.stack([cv for _, cv in states]).to(torch.bfloat16),
        "k": torch.zeros(kv_shape, dtype=k0.dtype, device=x.device),
        "v": torch.zeros(kv_shape, dtype=k0.dtype, device=x.device),
        "index": seq,
    }
    for i, (k, v) in enumerate(kvs):
        cache["k"][i, :, :, :seq] = k.transpose(1, 2)
        cache["v"][i, :, :, :seq] = v.transpose(1, 2)
    return logits, cache


def hybrid_decode_step(params: HybridLM, tokens: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One token per lane.  Updates ``cache`` in place (the reference returns
    a new cache) and returns (logits (b, 1, vocab_padded), cache).  The conv
    state takes the promoted dtype of the cached state and the activations,
    as the reference's does (float32 after the first step of a float32
    model, though a prefill leaves it bf16)."""
    n_stage, period = _stages(cfg)
    idx = int(cache["index"])
    if idx >= cache["k"].shape[3]:
        raise ValueError(f"KV cache full: index {idx} of {cache['k'].shape[3]} slots")
    x = params["embed"][tokens]
    b = x.shape[0]
    position = torch.full((b, 1), idx, dtype=torch.int32, device=x.device)
    conv_dt = torch.promote_types(cache["conv"].dtype, x.dtype)
    if cache["conv"].dtype != conv_dt:
        cache["conv"] = cache["conv"].to(conv_dt)
    for stage in range(n_stage):
        for j in range(period):
            layer = stage * period + j
            x, st, cv = mamba_decode_step(params["mamba"][layer], x, cache["ssm"][layer],
                                          cache["conv"][layer], cfg)
            cache["ssm"][layer] = st
            cache["conv"][layer] = cv
        x = dense_layer_decode(params["shared"], x, position, idx, cache["k"][stage],
                               cache["v"][stage], cfg)
    x = rms_norm(x, params["final_norm"])
    logits = torch.einsum("bsd,dv->bsv", x, params["head"])
    cache["index"] = idx + 1
    return logits, cache


def hybrid_train_logits(params: HybridLM, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Logits at every position (b, s, vocab_padded), each stage
    checkpointed unless ``remat`` is "none": on the card a checkpointed
    stage launches each Mamba2 layer's SSD forward and the shared block's
    attention forward twice (the forward and its recompute), and each
    backward kernel once, per step and microbatch."""
    n_stage, period = _stages(cfg)
    x = params["embed"][batch["tokens"]]
    b, seq = x.shape[:2]
    positions = _positions_for(b, seq, x.device)

    def stage(x, first):
        for layer in params["mamba"][first:first + period]:
            x = mamba_block(layer, x, cfg)[0]
        return dense_layer(params["shared"], x, positions, cfg)[0]

    run = remat(stage, "none" if cfg.remat == "none" else "full")
    for st in range(n_stage):
        x = run(x, st * period)
    x = rms_norm(x, params["final_norm"])
    return torch.einsum("bsd,dv->bsv", x, params["head"])


def hybrid_loss(params: HybridLM, batch: dict, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    return cross_entropy_loss(hybrid_train_logits(params, batch, cfg), batch["labels"],
                              cfg.vocab)
