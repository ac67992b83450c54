"""Dense decoder-only transformer (GQA, RoPE, qk-norm, SwiGLU): the port's
copy of ``repro.models.transformer``, serving path.

Covers qwen3-32b, minitron-8b, phi3-medium-14b and codeqwen1.5-7b, and
the attention block the hybrid family shares.  The reference stacks the
layers (a leading L dim) and applies them with ``lax.scan``; here each
layer is a ``DenseBlock`` in the ``blocks`` ModuleList of a ``DenseLM``
and a Python loop applies them.  MoE FFNs and M-RoPE (the moe and vlm
families) raise ``NotImplementedError``, as do loss and training
(ROADMAP, Queue 1).

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
from .common import DTYPES, Initializer, ParamModule, apply_rope, rms_norm, swiglu

__all__ = [
    "TP_MULTIPLE",
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
]

TP_MULTIPLE = 16  # the reference pads heads for its production model axis


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


def _refuse_unported(cfg: ArchConfig) -> None:
    if cfg.moe is not None or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: MoE FFNs and M-RoPE are not ported yet (the port runs the dense "
            f"SwiGLU with standard RoPE); see ROADMAP.md, Queue 1")


def _qkv(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    _refuse_unported(cfg)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
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
    """One attention + SwiGLU layer: ``attn`` (wq, wk, wv, wo, and q_norm,
    k_norm under qk-norm), ``mlp`` (w1, w3, w2), ``ln1`` and ``ln2``.  The
    hybrid family's shared block is one too."""

    def __init__(self, attn: dict, mlp: dict, ln1: torch.Tensor, ln2: torch.Tensor):
        super().__init__(ln1=ln1, ln2=ln2)
        self.attn = ParamModule(**attn)
        self.mlp = ParamModule(**mlp)

    @classmethod
    def init(cls, ini: Initializer, cfg: ArchConfig) -> "DenseBlock":
        hp, kvp, _ = padded_dims(cfg)
        d = cfg.d_model
        return cls(_attn_params(ini, d, hp, kvp, cfg.resolved_head_dim, cfg.qk_norm),
                   _mlp_params(ini, d, cfg.d_ff), ini.ones((d,)), ini.ones((d,)))


class DenseLM(ParamModule):
    """The dense model's weights: ``embed`` (vocab_padded, d), ``blocks`` (a
    ModuleList of the n_layers layers), ``final_norm`` and ``head``
    (d, vocab_padded).  Its state dict names follow the reference's tree
    with the layer axis unstacked (``blocks.<i>.attn.wq``)."""

    def __init__(self, embed, blocks: list, final_norm, head):
        super().__init__(embed=embed, final_norm=final_norm, head=head)
        self.blocks = nn.ModuleList(blocks)


def init_dense(cfg: ArchConfig, seed: int, device) -> DenseLM:
    """Weights drawn layer by layer (the reference draws each stacked
    (L, ...) tensor at once, which at qwen3-32b would need a 33.6 GB
    float32 temporary for w1)."""
    _refuse_unported(cfg)
    _, _, vp = padded_dims(cfg)
    d = cfg.d_model
    ini = Initializer(seed, DTYPES[cfg.dtype], device)
    embed = ini.normal((vp, d), stddev=1.0)
    blocks = [DenseBlock.init(ini, cfg) for _ in range(cfg.n_layers)]
    return DenseLM(embed, blocks, ini.ones((d,)), ini.normal((d, vp)))


def _ffn(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The dense SwiGLU (the reference's MoE branch is not ported)."""
    _refuse_unported(cfg)
    mlp = p["mlp"]
    return swiglu(x, mlp["w1"], mlp["w3"], mlp["w2"])


def _positions_for(b: int, seq: int, device) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device)[None].expand(b, seq)


def dense_layer(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One layer on a full sequence.  Returns (x_out, (k, v)), k and v in
    (b, s, kv, hd).  (The reference also returns the MoE router's aux loss,
    zero for a dense FFN.)"""
    h, kv = attn_block(p["attn"], rms_norm(x, p["ln1"]), positions, cfg)
    x = x + h
    return x + _ffn(p, rms_norm(x, p["ln2"]), cfg), kv


def dense_layer_decode(p, x: torch.Tensor, position: torch.Tensor, idx: int,
                       k_cache: torch.Tensor, v_cache: torch.Tensor, cfg: ArchConfig
                       ) -> torch.Tensor:
    """One layer on one token per lane, writing its k and v into slot
    ``idx`` of the (b, kv, S, hd) caches in place."""
    h, _, _ = attn_block_decode(p["attn"], rms_norm(x, p["ln1"]), position, idx,
                                k_cache, v_cache, cfg)
    x = x + h
    return x + _ffn(p, rms_norm(x, p["ln2"]), cfg)


def dense_init_cache(cfg: ArchConfig, batch: int, max_seq: int,
                     dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    _, kvp, _ = padded_dims(cfg)
    shape = (cfg.n_layers, batch, kvp, max_seq, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


def dense_prefill(params: DenseLM, tokens: torch.Tensor, cfg: ArchConfig, max_seq: int):
    """A full forward that writes each layer's k and v straight into a
    (L, b, kv, max_seq, hd) cache in the activations' dtype (the reference
    stacks them and pads).  Returns (last-position logits
    (b, 1, vocab_padded), cache)."""
    b, seq = tokens.shape
    if seq > max_seq:
        raise ValueError(f"prompt of {seq} tokens exceeds max_seq={max_seq}")
    x = params["embed"][tokens]
    positions = _positions_for(b, seq, x.device)
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
    position = torch.full((x.shape[0], 1), idx, dtype=torch.int32, device=x.device)
    for i, layer in enumerate(params["blocks"]):
        x = dense_layer_decode(layer, x, position, idx, cache["k"][i], cache["v"][i], cfg)
    x = rms_norm(x, params["final_norm"])
    cache["index"] = idx + 1
    return torch.einsum("bsd,dv->bsv", x, params["head"]), cache
