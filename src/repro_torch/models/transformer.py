"""Decoder-only transformer (GQA, RoPE/M-RoPE, qk-norm, SwiGLU or MoE FFN):
the port's copy of ``repro.models.transformer``, serving path.

Covers the dense family (qwen3-32b, minitron-8b, phi3-medium-14b,
codeqwen1.5-7b), the moe family (grok-1-314b, kimi-k2-1t-a32b: the FFN is
``moe.moe_ffn``), the qwen2-vl-2b backbone (patch embeddings enter before
the text as precomputed vectors, M-RoPE position streams as inputs), and
the attention block the hybrid and enc-dec families share.  The reference
stacks the layers (a leading L dim) and applies them with ``lax.scan``;
here each layer is a ``DenseBlock`` in the ``blocks`` ModuleList of a
``DenseLM`` and a Python loop applies them.  Training: ``dense_loss`` over
``dense_train_logits`` (logits at every position, the MoE router's aux
loss summed over the layers), each layer under the config's ``remat``
policy.

Weights keep the reference's layouts: ``wq`` (d, h, hd), ``wk``/``wv``
(d, kv, hd), ``wo`` (h, hd, d), so the einsums read the same.  Head
padding is the reference's: Q heads pad to a multiple of 16 and KV heads
to a divisor of the padded Q heads (phi3: 40 -> 48 Q, 10 -> 12 KV).
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from .attention import attention, decode_attention
from .common import (DTYPES, Initializer, ParamModule, apply_rope, cross_entropy_loss, remat,
                     rms_norm, swiglu)
from .moe import init_moe_ffn, moe_ffn

__all__ = [
    "TP_MULTIPLE",
    "MROPE_SECTIONS",
    "padded_dims",
    "attn_block",
    "attn_block_decode",
    "DenseBlock",
    "DenseLM",
    "init_dense",
    "dense_layer",
    "dense_layer_decode",
    "dense_init_cache",
    "dense_prefill",
    "dense_decode_step",
    "dense_train_logits",
    "dense_loss",
]

TP_MULTIPLE = 16  # the reference pads heads for its production model axis

MROPE_SECTIONS = (16, 24, 24)  # qwen2-vl half-dim split (t, h, w)


def padded_dims(cfg: ArchConfig) -> tuple[int, int, int]:
    """(padded_q_heads, padded_kv_heads, padded_vocab), as the reference
    pads them (padded heads have zero output rows at init)."""
    hp = cfg.heads_padded(TP_MULTIPLE)
    kv = cfg.n_kv_heads
    while hp % kv:
        kv += 1
    return hp, kv, cfg.vocab_padded(TP_MULTIPLE)


def _attn_params(ini: Initializer, d: int, hp: int, kvp: int, hd: int, qk_norm: bool) -> dict:
    """One attention block's weights, drawn with the reference's std rules
    (a stacked (1, ...) draw has the same fan-in as this unstacked one)."""
    p = {
        "wq": ini.normal((d, hp, hd)),
        "wk": ini.normal((d, kvp, hd)),
        "wv": ini.normal((d, kvp, hd)),
        "wo": ini.normal((hp, hd, d), stddev=1.0 / (hp * hd) ** 0.5),
    }
    if qk_norm:
        p["q_norm"] = ini.ones((hd,))
        p["k_norm"] = ini.ones((hd,))
    return p


def _mlp_params(ini: Initializer, d: int, f: int) -> dict:
    return {"w1": ini.normal((d, f)), "w3": ini.normal((d, f)), "w2": ini.normal((f, d))}


def _qkv(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    sections = MROPE_SECTIONS if cfg.mrope else None
    q = apply_rope(q, positions, cfg.rope_theta, sections)
    k = apply_rope(k, positions, cfg.rope_theta, sections)
    return q, k, v


def attn_block(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
               causal: bool = True) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (prefill).  Returns (out, (k, v)), k and v in
    (b, s, kv, hd)."""
    q, k, v = _qkv(p, x, positions, cfg)
    o = attention(q, k, v, causal=causal)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), (k, v)


def attn_block_decode(p, x: torch.Tensor, position: torch.Tensor, idx: int,
                      k_cache: torch.Tensor, v_cache: torch.Tensor, cfg: ArchConfig
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention.  Writes the token's k and v into slot ``idx`` of
    the (b, kv, S, hd) caches in place (the reference returns updated
    copies) and returns (out, k_cache, v_cache)."""
    q, k, v = _qkv(p, x, position, cfg)
    k_cache[:, :, idx] = k[:, 0]
    v_cache[:, :, idx] = v[:, 0]
    S = k_cache.shape[2]
    length_mask = (torch.arange(S, device=x.device) <= idx)[None, :].expand(x.shape[0], S)
    o = decode_attention(q, k_cache, v_cache, length_mask)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), k_cache, v_cache


# ------------------------------------------------------------------------------
# The dense model
# ------------------------------------------------------------------------------

class DenseBlock(ParamModule):
    """One attention + FFN layer: ``attn`` (wq, wk, wv, wo, and q_norm,
    k_norm under qk-norm), ``ln1``, ``ln2`` and either ``mlp`` (w1, w3, w2)
    or, for a config with ``moe``, ``moe`` (router, w1, w3, w2 and perhaps
    ``shared``).  The hybrid family's shared block is one too."""

    @classmethod
    def init(cls, ini: Initializer, cfg: ArchConfig) -> "DenseBlock":
        hp, kvp, _ = padded_dims(cfg)
        d = cfg.d_model
        attn = _attn_params(ini, d, hp, kvp, cfg.resolved_head_dim, cfg.qk_norm)
        if cfg.moe is not None:
            ffn = {"moe": init_moe_ffn(ini, cfg)}
        else:
            ffn = {"mlp": _mlp_params(ini, d, cfg.d_ff)}
        return cls(attn=attn, **ffn, ln1=ini.ones((d,)), ln2=ini.ones((d,)))


class DenseLM(ParamModule):
    """The dense model's weights: ``embed`` (vocab_padded, d), ``blocks`` (a
    ModuleList of the n_layers layers), ``final_norm`` and ``head``
    (d, vocab_padded).  Its state dict names follow the reference's tree
    with the layer axis unstacked (``blocks.<i>.attn.wq``)."""

    def __init__(self, embed, blocks: list, final_norm, head):
        super().__init__(embed=embed, final_norm=final_norm, head=head)
        self.blocks = nn.ModuleList(blocks)


def init_dense(cfg: ArchConfig, seed: int, device) -> DenseLM:
    """Weights drawn layer by layer, and an MoE layer's experts one expert
    at a time (the reference draws each stacked (L, ...) tensor at once,
    which at qwen3-32b would need a 33.6 GB float32 temporary for w1)."""
    _, _, vp = padded_dims(cfg)
    d = cfg.d_model
    ini = Initializer(seed, DTYPES[cfg.dtype], device)
    embed = ini.normal((vp, d), stddev=1.0)
    blocks = [DenseBlock.init(ini, cfg) for _ in range(cfg.n_layers)]
    return DenseLM(embed, blocks, ini.ones((d,)), ini.normal((d, vp)))


def _ffn(p, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The dense SwiGLU or the MoE FFN: (y, the router's aux loss, or None
    for a dense FFN).  Serving drops the aux; training sums it."""
    if cfg.moe is not None:
        return moe_ffn(p["moe"], x, cfg)
    mlp = p["mlp"]
    return swiglu(x, mlp["w1"], mlp["w3"], mlp["w2"]), None


def _positions_for(b: int, seq: int, device, mrope: bool = False) -> torch.Tensor:
    """Positions 0..seq-1 for every lane: (b, seq), or (3, b, seq) with the
    three M-RoPE streams equal (text only)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None].expand(b, seq)
    return pos[None].expand(3, b, seq) if mrope else pos


def _embed_inputs(params, tokens: torch.Tensor, cfg: ArchConfig,
                  img_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings, with a vlm batch's image embeddings placed before
    the text."""
    x = params["embed"][tokens]
    if cfg.family == "vlm" and img_embeds is not None:
        x = torch.cat([img_embeds.to(x.dtype), x], dim=1)
    return x


def dense_layer(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One layer on a full sequence.  Returns (x_out, (k, v)), k and v in
    (b, s, kv, hd).  (The reference also returns the MoE router's aux loss,
    which serving does not read.)"""
    h, kv = attn_block(p["attn"], rms_norm(x, p["ln1"]), positions, cfg)
    x = x + h
    return x + _ffn(p, rms_norm(x, p["ln2"]), cfg)[0], kv


def dense_layer_decode(p, x: torch.Tensor, position: torch.Tensor, idx: int,
                       k_cache: torch.Tensor, v_cache: torch.Tensor, cfg: ArchConfig
                       ) -> torch.Tensor:
    """One layer on one token per lane, writing its k and v into slot
    ``idx`` of the (b, kv, S, hd) caches in place."""
    h, _, _ = attn_block_decode(p["attn"], rms_norm(x, p["ln1"]), position, idx,
                                k_cache, v_cache, cfg)
    x = x + h
    return x + _ffn(p, rms_norm(x, p["ln2"]), cfg)[0]


def dense_init_cache(cfg: ArchConfig, batch: int, max_seq: int,
                     dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    _, kvp, _ = padded_dims(cfg)
    shape = (cfg.n_layers, batch, kvp, max_seq, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


def dense_prefill(params: DenseLM, tokens: torch.Tensor, cfg: ArchConfig, max_seq: int,
                  img_embeds: torch.Tensor | None = None,
                  positions: torch.Tensor | None = None):
    """A full forward that writes each layer's k and v straight into a
    (L, b, kv, max_seq, hd) cache in the activations' dtype (the reference
    stacks them and pads).  A vlm batch may add ``img_embeds`` (b, img, d),
    which come before the text, and ``positions`` ((3, b, img + text) for
    M-RoPE); without them the positions are 0..seq-1 on every stream.
    Returns (last-position logits (b, 1, vocab_padded), cache)."""
    x = _embed_inputs(params, tokens, cfg, img_embeds)
    b, seq = x.shape[:2]
    if seq > max_seq:
        raise ValueError(f"prompt of {seq} tokens exceeds max_seq={max_seq}")
    if positions is None:
        positions = _positions_for(b, seq, x.device, cfg.mrope)
    cache = dense_init_cache(cfg, b, max_seq, dtype=x.dtype, device=x.device)
    for i, layer in enumerate(params["blocks"]):
        x, (k, v) = dense_layer(layer, x, positions, cfg)
        cache["k"][i, :, :, :seq] = k.transpose(1, 2)
        cache["v"][i, :, :, :seq] = v.transpose(1, 2)
    x = rms_norm(x[:, -1:], params["final_norm"])
    cache["index"] = seq
    return torch.einsum("bsd,dv->bsv", x, params["head"]), cache


def dense_decode_step(params: DenseLM, tokens: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One token per lane.  Updates ``cache`` in place (the reference returns
    a new cache) and returns (logits (b, 1, vocab_padded), cache)."""
    idx = int(cache["index"])
    if idx >= cache["k"].shape[3]:
        raise ValueError(f"KV cache full: index {idx} of {cache['k'].shape[3]} slots")
    x = params["embed"][tokens]
    # the cache index on every stream under M-RoPE, as the reference has it
    position = _positions_for(x.shape[0], 1, x.device, cfg.mrope) + idx
    for i, layer in enumerate(params["blocks"]):
        x = dense_layer_decode(layer, x, position, idx, cache["k"][i], cache["v"][i], cfg)
    x = rms_norm(x, params["final_norm"])
    cache["index"] = idx + 1
    return torch.einsum("bsd,dv->bsv", x, params["head"]), cache


# ------------------------------------------------------------------------------
# Training
# ------------------------------------------------------------------------------

def _attn_half(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The residual after a layer's attention (the reference's
    ``resid_attn``)."""
    return x + attn_block(p["attn"], rms_norm(x, p["ln1"]), positions, cfg)[0]


def _ffn_half(p, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual after a layer's FFN (``resid_mlp``) and the MoE router's
    aux loss (a 0-d fp32 zero for a dense FFN)."""
    y, aux = _ffn(p, rms_norm(x, p["ln2"]), cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def dense_train_layer(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer on a full sequence under ``cfg.remat``: (x_out, aux).
    ``"full"`` and ``"dots"`` checkpoint the whole layer (``common.remat``);
    ``"names"`` keeps exactly the two residuals, as the reference's
    ``save_only_these_names("resid_attn", "resid_mlp")``: each half is a
    checkpointed segment, so a residual is kept as the next segment's
    input and everything else is recomputed."""
    if cfg.remat == "names":
        x = remat(_attn_half, "full")(p, x, positions, cfg)
        return remat(_ffn_half, "full")(p, x, cfg)

    def layer(p, x, positions):
        return _ffn_half(p, _attn_half(p, x, positions, cfg), cfg)

    return remat(layer, cfg.remat)(p, x, positions)


def dense_train_logits(params, batch: dict, cfg: ArchConfig
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Logits at every position (b, s, vocab_padded) and the router aux
    summed over the layers, from a batch of tensors: ``tokens``, and for a
    vlm ``img_embeds`` (before the text) and ``positions`` if given."""
    x = _embed_inputs(params, batch["tokens"], cfg, batch.get("img_embeds"))
    b, seq = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions_for(b, seq, x.device, cfg.mrope)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["blocks"]:
        x, a = dense_train_layer(layer, x, positions, cfg)
        aux = aux + a
    x = rms_norm(x, params["final_norm"])
    return torch.einsum("bsd,dv->bsv", x, params["head"]), aux


def dense_loss(params, batch: dict, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """(loss, metrics): the cross-entropy of the text positions (a vlm's
    image positions are cut), plus ``router_aux_coef * aux / n_layers``
    for an MoE config (then also in the metrics as ``router_aux``)."""
    logits, aux = dense_train_logits(params, batch, cfg)
    if cfg.family == "vlm" and "img_embeds" in batch:
        logits = logits[:, batch["img_embeds"].shape[1]:]
    loss, metrics = cross_entropy_loss(logits, batch["labels"], cfg.vocab)
    if cfg.moe is not None:
        aux_term = cfg.moe.router_aux_coef * aux / cfg.n_layers
        loss = loss + aux_term
        metrics = dict(metrics, loss=loss, router_aux=aux_term.detach())
    return loss, metrics
