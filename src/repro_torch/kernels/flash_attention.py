"""Forward attention with an online softmax: the wrapper of the hand-written
CUDA kernel ``flash_attention_kernel`` (``csrc/flash_attention.cu``) and its
plain PyTorch version (the counterpart of
``repro.kernels.flash_attention.flash_attention_fwd``).

Layout is the reference kernel's: q (b, h, sq, hd), k and v (b, kv, skv, hd),
with GQA through the head index (KV head = h // (h / kv)) and causal masking
on absolute positions (query i sits at ``q_offset + i``).  Unlike the
reference kernel, any sq and skv are taken (a ragged tail is masked) and hd
is not padded outside the kernel.

``flash_attention_fwd`` launches the kernel on a CUDA tensor (any strides
over the first three dimensions, a contiguous last one: the model's
(b, s, h, hd) tensors pass as ``.transpose(1, 2)`` views without a copy) or
raises; on a CPU tensor it runs ``flash_attention_plain``.  It counts its
launches in ``flash_attention_fwd.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["NEG_INF", "MAX_HEAD_DIM", "flash_attention_fwd", "flash_attention_plain"]

NEG_INF = -1e30
MAX_HEAD_DIM = 128  # the kernel keeps hd / 16 output columns per thread, at most 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, q_offset: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops: fp32 scores of the pre-scaled
    query, logits masked to -1e30, softmax statistics in fp32, the
    denominator clamped at 1e-30, the output in q's dtype."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float() * scale, kf.transpose(-1, -2))  # (b, h, sq, skv)
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(skv, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return (torch.matmul(p, vf) / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """Attention over (b, h, sq, hd) queries and (b, kv, skv, hd) keys and
    values -> (b, h, sq, hd) in q's dtype.  ``scale`` defaults to
    ``hd ** -0.5``.  Launches ``flash_attention_kernel`` on a CUDA tensor
    (one block per 64-query tile, head and batch); runs
    ``flash_attention_plain`` on a CPU tensor."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention_fwd takes (b, h, sq, hd) and (b, kv, skv, hd) "
                         f"tensors, got {tuple(q.shape)} and {tuple(k.shape)}")
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    dev = q.device
    _build.check_tensor("q", q, (b, h, sq, hd), (q.dtype,), dev, contiguous=False)
    _build.check_tensor("k", k, (b, kvh, skv, hd), (q.dtype,), dev, contiguous=False)
    _build.check_tensor("v", v, (b, kvh, skv, hd), (q.dtype,), dev, contiguous=False)
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    scale = hd ** -0.5 if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal, q_offset, scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on a CUDA or CPU tensor, got {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_kernel takes float32 or bfloat16, got {q.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_kernel takes hd <= {MAX_HEAD_DIM}, got {hd}")
    if skv == 0:
        raise ValueError("flash_attention_fwd needs at least one key")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
    # (b, h, sq, hd) view of a (b, sq, h, hd) tensor: the model's layout
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    err = _build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, kvh, sq, skv, hd, _DTYPES[q.dtype], int(bool(causal)), int(q_offset),
        scale, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(err, "flash_attention_kernel")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
