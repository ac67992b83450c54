"""Attention: the prefill path through the flash-attention kernel and a
grouped decode path over the KV cache (the port's copy of
``repro.models.attention``).

Numerics: logits and softmax statistics in fp32, outputs in the activation
dtype.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from .sharding import all_max, psum

__all__ = ["attention", "decode_attention", "local_kv_heads", "NEG_INF"]

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


def local_kv_heads(k: torch.Tensor, v: torch.Tensor, r: int, h_loc: int, g: int):
    """The kv heads that query heads r*h_loc .. (r+1)*h_loc - 1 read (global
    query head i reads kv head i // g), as (b, s, kv_loc, hd) tensors whose
    local GQA map j -> j // (h_loc / kv_loc) is right: a run of whole groups
    when h_loc is a multiple of g; the one shared kv head when g is a
    multiple of h_loc (qwen3-32b's 64/8 heads on 16 shards: two shards read
    one kv head); else each query head's own kv head."""
    base = r * h_loc
    if h_loc % g == 0:
        lo, n = base // g, h_loc // g
    elif g % h_loc == 0:
        lo, n = base // g, 1
    else:
        idx = torch.div(base + torch.arange(h_loc, device=k.device), g, rounding_mode="floor")
        return k.index_select(2, idx), v.index_select(2, idx)
    return k[:, :, lo:lo + n], v[:, :, lo:lo + n]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length_mask: torch.Tensor, group=None) -> torch.Tensor:
    """Single-token attention against a KV cache, grouped so the cache is
    never repeated to full heads.  q (b, 1, h, hd), caches (b, kv, S, hd),
    length_mask (b, S) True where a slot is valid -> (b, 1, h, hd).
    PyTorch ops: one query token is a plain product, outside any kernel.
    Products take fp32 inputs, as the reference's bf16 products accumulate
    into fp32 (``preferred_element_type``).  On a mesh whose model axis
    splits the cache's slots ("kv_seq" -> model), ``group`` is that axis's:
    the softmax's max and sums and the output reduce over it."""
    b, sq, h, hd = q.shape
    if sq != 1:
        raise ValueError(f"decode_attention takes one query token, got {sq}")
    kvh = k_cache.shape[1]
    g = h // kvh
    qg = q[:, 0].reshape(b, kvh, g, hd)
    logits = torch.einsum("bkgd,bksd->bkgs", qg.float(), k_cache.float()) * hd ** -0.5
    logits = logits.masked_fill(~length_mask[:, None, None, :], NEG_INF)
    m = all_max(logits.amax(dim=-1, keepdim=True), group)
    p = torch.exp(logits - m)
    l = psum(p.sum(dim=-1, keepdim=True), group)
    probs = (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype)
    out = psum(torch.einsum("bkgs,bksd->bkgd", probs.float(), v_cache.float()), group)
    return out.reshape(b, 1, h, hd).to(q.dtype)
