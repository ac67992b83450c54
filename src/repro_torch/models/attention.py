"""Attention: the prefill path through the flash-attention kernel and a
grouped decode path over the KV cache (the port's copy of
``repro.models.attention``).

Numerics: logits and softmax statistics in fp32, outputs in the activation
dtype.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops

__all__ = ["attention", "decode_attention", "NEG_INF"]

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
              q_offset: int = 0) -> torch.Tensor:
    """Multi-head attention with GQA: q (b, sq, h, hd), k/v (b, skv, kv, hd) ->
    (b, sq, h, hd).  ``q_offset`` is the absolute position of q[0] relative
    to k[0]; causal masking uses absolute positions.  On a CUDA tensor this
    launches ``flash_attention_kernel``; on a CPU tensor it runs the
    kernel's plain version.  (The reference's chunked jnp path and its
    ``use_pallas`` switch have no counterpart: the kernel tiles itself.)"""
    return kops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length_mask: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a KV cache, grouped so the cache is
    never repeated to full heads.  q (b, 1, h, hd), caches (b, kv, S, hd),
    length_mask (b, S) True where a slot is valid -> (b, 1, h, hd).
    PyTorch ops: one query token is a plain product, outside any kernel.
    Products take fp32 inputs, as the reference's bf16 products accumulate
    into fp32 (``preferred_element_type``)."""
    b, sq, h, hd = q.shape
    if sq != 1:
        raise ValueError(f"decode_attention takes one query token, got {sq}")
    kvh = k_cache.shape[1]
    g = h // kvh
    qg = q[:, 0].reshape(b, kvh, g, hd)
    logits = torch.einsum("bkgd,bksd->bkgs", qg.float(), k_cache.float()) * hd ** -0.5
    logits = logits.masked_fill(~length_mask[:, None, None, :], NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    probs = (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype)
    out = torch.einsum("bkgs,bksd->bkgd", probs.float(), v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)
