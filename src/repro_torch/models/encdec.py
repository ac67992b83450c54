"""Whisper-style encoder-decoder backbone: the port's copy of
``repro.models.encdec``, serving path.

The audio (conv/mel) frontend is a stub, as in the reference: the batch
carries precomputed frame embeddings (b, enc_seq, d).  The encoder is
bidirectional self-attention with RoPE on positions 0..enc_seq-1; the
decoder is causal self-attention, then cross-attention (no RoPE) into the
encoder output, then a SwiGLU.  Every prefill attention, encoder, decoder
and cross, goes through ``attention`` (the flash-attention kernel on the
card, non-causal where the reference's is).

Decode: the self-attention KV cache grows; the cross-attention K/V are
computed once from the encoder output at prefill and stay fixed, and each
step attends to all of them (``decode_attention`` with an all-true mask).
Caches are written in place, as the dense path does.  Training:
``encdec_loss``, each decoder layer checkpointed unless ``remat`` is
"none" (the reference's ``jax.checkpoint``; the encoder is not).
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from .attention import attention, decode_attention
from .common import DTYPES, Initializer, ParamModule, cross_entropy_loss, remat, rms_norm, swiglu
from .transformer import (_attn_params, _mlp_params, _positions_for, attn_block,
                          attn_block_decode, padded_dims)

__all__ = [
    "EncDecLM",
    "init_encdec",
    "encode",
    "encdec_param_axes",
    "encdec_cache_axes",
    "encdec_init_cache",
    "encdec_prefill",
    "encdec_decode_step",
    "encdec_train_logits",
    "encdec_loss",
]


class EncDecLM(ParamModule):
    """The enc-dec model's weights: ``embed`` (vocab_padded, d),
    ``enc_blocks`` (enc_layers of attn, mlp, ln1, ln2), ``enc_norm``,
    ``dec_blocks`` (n_layers of attn, cross, mlp, ln1, ln2, ln3),
    ``final_norm`` and ``head`` (d, vocab_padded).  Its state dict names
    follow the reference's tree with each stack's layer axis unstacked
    (``enc_blocks.<i>.attn.wq``, ``dec_blocks.<i>.cross.wq``)."""

    def __init__(self, embed, enc_blocks: list, enc_norm, dec_blocks: list, final_norm, head):
        super().__init__(embed=embed, enc_norm=enc_norm, final_norm=final_norm, head=head)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.dec_blocks = nn.ModuleList(dec_blocks)


def init_encdec(cfg: ArchConfig, seed: int, device) -> EncDecLM:
    """Weights drawn layer by layer with the reference's std rules."""
    hp, kvp, vp = padded_dims(cfg)
    hd = cfg.resolved_head_dim
    d, f = cfg.d_model, cfg.d_ff
    ini = Initializer(seed, DTYPES[cfg.dtype], device)
    embed = ini.normal((vp, d), stddev=1.0)
    enc = [ParamModule(attn=_attn_params(ini, d, hp, kvp, hd, cfg.qk_norm),
                       mlp=_mlp_params(ini, d, f), ln1=ini.ones((d,)), ln2=ini.ones((d,)))
           for _ in range(cfg.enc_layers)]
    enc_norm = ini.ones((d,))
    dec = [ParamModule(attn=_attn_params(ini, d, hp, kvp, hd, cfg.qk_norm),
                       cross=_attn_params(ini, d, hp, kvp, hd, cfg.qk_norm),
                       mlp=_mlp_params(ini, d, f), ln1=ini.ones((d,)), ln2=ini.ones((d,)),
                       ln3=ini.ones((d,)))
           for _ in range(cfg.n_layers)]
    return EncDecLM(embed, enc, enc_norm, dec, ini.ones((d,)), ini.normal((d, vp)))


def _mlp(p, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["w1"], p["w3"], p["w2"])


def encode(params: EncDecLM, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The bidirectional encoder over frame embeddings (b, s_enc, d), cast
    to the model's dtype -> (b, s_enc, d) after the encoder norm."""
    x = frames.to(DTYPES[cfg.dtype])
    b, s = x.shape[:2]
    positions = _positions_for(b, s, x.device)
    for lp in params["enc_blocks"]:
        x = _enc_layer(lp, x, positions, cfg)
    return rms_norm(x, params["enc_norm"])


def _enc_layer(lp, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """One encoder layer: bidirectional self-attention, then a SwiGLU."""
    h, _ = attn_block(lp["attn"], rms_norm(x, lp["ln1"]), positions, cfg, causal=False)
    x = x + h
    return x + _mlp(lp["mlp"], rms_norm(x, lp["ln2"]))


def _cross_kv(p, enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V from the encoder output: (b, s_enc, kv, hd) each."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    return k, v


def _cross_attend(p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])  # no RoPE on cross-attention
    o = attention(q, k, v, causal=False)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def _dec_layer(lp, x: torch.Tensor, positions: torch.Tensor, enc_k: torch.Tensor,
               enc_v: torch.Tensor, cfg: ArchConfig):
    """One decoder layer on a full sequence: (x_out, (k, v)) of its
    self-attention, in (b, s, kv, hd)."""
    h, kv = attn_block(lp["attn"], rms_norm(x, lp["ln1"]), positions, cfg, causal=True)
    x = x + h
    x = x + _cross_attend(lp["cross"], rms_norm(x, lp["ln2"]), enc_k, enc_v)
    x = x + _mlp(lp["mlp"], rms_norm(x, lp["ln3"]))
    return x, kv


def _dec_layer_decode(lp, x: torch.Tensor, position: torch.Tensor, idx: int,
                      k_cache: torch.Tensor, v_cache: torch.Tensor, cross_k: torch.Tensor,
                      cross_v: torch.Tensor, mask: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """One decoder layer on one token per lane: self-attention writing slot
    ``idx`` of the (b, kv, S, hd) caches in place, cross-attention over the
    fixed (b, kv, s_enc, hd) encoder K/V, then the SwiGLU."""
    h, _, _ = attn_block_decode(lp["attn"], rms_norm(x, lp["ln1"]), position, idx,
                                k_cache, v_cache, cfg)
    x = x + h
    q = torch.einsum("bsd,dhk->bshk", rms_norm(x, lp["ln2"]), lp["cross"]["wq"])
    o = decode_attention(q, cross_k, cross_v, mask)
    x = x + torch.einsum("bshk,hkd->bsd", o, lp["cross"]["wo"])
    return x + _mlp(lp["mlp"], rms_norm(x, lp["ln3"]))


def encdec_param_axes(cfg: ArchConfig) -> dict:
    """Logical dim names of the encoder-decoder's weights, stacked (the
    layer dim first), as the reference's."""
    attn = {
        "wq": (None, "w_embed", "w_heads", None),
        "wk": (None, "w_embed", "w_kv_heads", None),
        "wv": (None, "w_embed", "w_kv_heads", None),
        "wo": (None, "w_heads", None, "w_embed"),
    }
    mlp = {"w1": (None, "w_embed", "w_ff"), "w3": (None, "w_embed", "w_ff"),
           "w2": (None, "w_ff", "w_embed")}
    return {
        "embed": ("w_vocab", "w_embed"),
        "enc_blocks": {"attn": dict(attn), "mlp": dict(mlp), "ln1": (None, None),
                       "ln2": (None, None)},
        "enc_norm": (None,),
        "dec_blocks": {"attn": dict(attn), "cross": dict(attn), "mlp": dict(mlp),
                       "ln1": (None, None), "ln2": (None, None), "ln3": (None, None)},
        "final_norm": (None,),
        "head": ("w_embed", "w_vocab"),
    }


def encdec_cache_axes() -> dict:
    return {
        "k": (None, "batch", "kv_heads", "kv_seq", None),
        "v": (None, "batch", "kv_heads", "kv_seq", None),
        "cross_k": (None, "batch", "kv_heads", None, None),
        "cross_v": (None, "batch", "kv_heads", None, None),
        "index": (),
    }


def encdec_init_cache(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype: torch.dtype = torch.bfloat16, device=None,
                      enc_seq: int | None = None) -> dict:
    """Self-attention caches (L, b, kv, max_seq, hd), cross-attention caches
    (L, b, kv, enc_seq, hd) (``cfg.enc_seq`` unless given) and the index."""
    _, kvp, _ = padded_dims(cfg)
    hd = cfg.resolved_head_dim
    L = cfg.n_layers
    s_enc = cfg.enc_seq if enc_seq is None else enc_seq
    zeros = lambda s: torch.zeros((L, batch, kvp, s, hd), dtype=dtype, device=device)
    return {"k": zeros(max_seq), "v": zeros(max_seq), "cross_k": zeros(s_enc),
            "cross_v": zeros(s_enc), "index": 0}


def encdec_prefill(params: EncDecLM, tokens: torch.Tensor, frames: torch.Tensor,
                   cfg: ArchConfig, max_seq: int):
    """Encode the frames, then a full decoder forward over the prompt that
    writes each layer's self-attention k/v and cross-attention k/v into the
    cache in the activations' dtype.  Returns (last-position logits
    (b, 1, vocab_padded), cache)."""
    enc_out = encode(params, frames, cfg)
    x = params["embed"][tokens]
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
    positions = _positions_for(b, s, x.device)
    cache = encdec_init_cache(cfg, b, max_seq, dtype=x.dtype, device=x.device,
                              enc_seq=enc_out.shape[1])
    for i, lp in enumerate(params["dec_blocks"]):
        enc_k, enc_v = _cross_kv(lp["cross"], enc_out)
        x, (k, v) = _dec_layer(lp, x, positions, enc_k, enc_v, cfg)
        cache["k"][i, :, :, :s] = k.transpose(1, 2)
        cache["v"][i, :, :, :s] = v.transpose(1, 2)
        cache["cross_k"][i] = enc_k.transpose(1, 2)
        cache["cross_v"][i] = enc_v.transpose(1, 2)
    x = rms_norm(x[:, -1:], params["final_norm"])
    cache["index"] = s
    return torch.einsum("bsd,dv->bsv", x, params["head"]), cache


def encdec_decode_step(params: EncDecLM, tokens: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One token per lane against the growing self-attention cache and the
    fixed cross-attention cache.  Updates ``cache`` in place and returns
    (logits (b, 1, vocab_padded), cache)."""
    idx = int(cache["index"])
    if idx >= cache["k"].shape[3]:
        raise ValueError(f"KV cache full: index {idx} of {cache['k'].shape[3]} slots")
    x = params["embed"][tokens]
    b = x.shape[0]
    position = torch.full((b, 1), idx, dtype=torch.int32, device=x.device)
    mask = torch.ones((b, cache["cross_k"].shape[3]), dtype=torch.bool, device=x.device)
    for i, lp in enumerate(params["dec_blocks"]):
        x = _dec_layer_decode(lp, x, position, idx, cache["k"][i], cache["v"][i],
                              cache["cross_k"][i], cache["cross_v"][i], mask, cfg)
    x = rms_norm(x, params["final_norm"])
    cache["index"] = idx + 1
    return torch.einsum("bsd,dv->bsv", x, params["head"]), cache


def encdec_train_logits(params: EncDecLM, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Decoder logits at every position (b, s, vocab_padded) of ``tokens``
    against the encoded ``frames``."""
    enc_out = encode(params, batch["frames"], cfg)
    x = params["embed"][batch["tokens"]]
    b, s = x.shape[:2]
    positions = _positions_for(b, s, x.device)

    def body(lp, x):
        enc_k, enc_v = _cross_kv(lp["cross"], enc_out)
        return _dec_layer(lp, x, positions, enc_k, enc_v, cfg)[0]

    run = remat(body, "none" if cfg.remat == "none" else "full")
    for lp in params["dec_blocks"]:
        x = run(lp, x)
    x = rms_norm(x, params["final_norm"])
    return torch.einsum("bsd,dv->bsv", x, params["head"])


def encdec_loss(params: EncDecLM, batch: dict, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    return cross_entropy_loss(encdec_train_logits(params, batch, cfg), batch["labels"],
                              cfg.vocab)
