"""The attention block of the transformer family, as the hybrid family uses
it (the port's copy of the parts of ``repro.models.transformer`` that
``hybrid`` imports).  The dense-family entry points are not ported yet
(ROADMAP, Queue 1).

Weights keep the reference's layouts: ``wq`` (d, h, hd), ``wk``/``wv``
(d, kv, hd), ``wo`` (h, hd, d), so the einsums read the same.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .attention import attention, decode_attention
from .common import Initializer, apply_rope, rms_norm

__all__ = [
    "TP_MULTIPLE",
    "padded_dims",
    "attn_block",
    "attn_block_decode",
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


def _qkv(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
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
