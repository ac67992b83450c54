"""Forward attention with an online softmax: the wrapper of the hand-written
CUDA kernels of ``csrc/flash_attention.cu`` and their plain PyTorch version
(the counterpart of ``repro.kernels.flash_attention.flash_attention_fwd``).

Layout is the reference kernel's: q (b, h, sq, hd), k and v (b, kv, skv, hd),
with GQA through the head index (KV head = h // (h / kv)) and causal masking
on absolute positions (query i sits at ``q_offset + i``).  Unlike the
reference kernel, any sq and skv are taken (a ragged tail is masked) and hd
is not padded outside the kernel.

``flash_attention_fwd`` launches a kernel on a CUDA tensor or raises; on a
CPU tensor it runs ``flash_attention_plain``.  The dtype picks the kernel:
bfloat16 runs ``flash_attention_kernel`` (tensor cores through ``wgmma``, K
and V streamed by TMA; hd a multiple of 8, 16-byte aligned tensors and
strides), float32 runs ``flash_attention_fp32_kernel`` (CUDA cores, which
keep the reference's fp32 products).  Any strides over the first three
dimensions and a contiguous last one are taken: the model's (b, s, h, hd)
tensors pass as ``.transpose(1, 2)`` views without a copy.  It counts its
launches in ``flash_attention_fwd.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["NEG_INF", "MAX_HEAD_DIM", "flash_attention_fwd", "flash_attention_plain",
           "wgmma_layout_probe"]

NEG_INF = -1e30
MAX_HEAD_DIM = 128  # bf16: 8 slabs of 16 columns; fp32: hd / 16 columns per thread
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


def _tma_strides(name: str, t: torch.Tensor) -> list[int]:
    """(batch, head, seq) strides of a bf16 tensor in elements, as the TMA
    takes them: 16-byte aligned base and strides; a dimension of size 1 is
    never stepped, so its stride is set to a legal value."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary for the TMA "
                         f"(data_ptr {t.data_ptr():#x})")
    hd = t.shape[-1]
    out = []
    for i in range(3):
        st = t.stride(i) if t.shape[i] > 1 else hd
        if st <= 0 or (2 * st) % 16:
            raise ValueError(f"{name} has stride {st} elements in dimension {i}: the TMA needs "
                             f"a positive multiple of 16 bytes")
        out.append(st)
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """Attention over (b, h, sq, hd) queries and (b, kv, skv, hd) keys and
    values -> (b, h, sq, hd) in q's dtype.  ``scale`` defaults to
    ``hd ** -0.5``.  Launches ``flash_attention_kernel`` (bf16: one resident
    block per SM walking the 128-query tiles of every head) or
    ``flash_attention_fp32_kernel`` (fp32: one block per 64-query tile) on a
    CUDA tensor; runs ``flash_attention_plain`` on a CPU tensor."""
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
    if q.dtype == torch.bfloat16:
        if hd % 8:
            raise ValueError(f"flash_attention_kernel takes bf16 hd % 8 == 0 (wgmma widths, "
                             f"16-byte TMA strides), got hd={hd}")
        st = [x for name, t in (("q", q), ("k", k), ("v", v)) for x in _tma_strides(name, t)]
    else:
        st = [t.stride(i) for t in (q, k, v) for i in range(3)]
    strides = (ctypes.c_longlong * 12)(*st, *(out.stride(i) for i in range(3)))
    err = _build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, kvh, sq, skv, hd, _DTYPES[q.dtype], int(bool(causal)), int(q_offset),
        scale, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(err, "flash_attention_kernel")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def wgmma_layout_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernel's fragment layouts, checked on the card: q (64, hd),
    k and v (128, hd) contiguous bf16 CUDA tensors -> (s, o) fp32, where
    s (64, 128) = q k^T and o (64, 16 ceil(hd / 16)) = bf16(s) v are computed
    with the kernel's loads, descriptors and products, and each accumulator
    register is written at the row and column the kernel assumes it holds.
    Not counted in ``flash_attention_fwd.launches``."""
    hd = q.shape[-1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"wgmma_layout_probe runs on a CUDA tensor, got {dev}")
    _build.check_tensor("q", q, (64, hd), (torch.bfloat16,), dev)
    _build.check_tensor("k", k, (128, hd), (torch.bfloat16,), dev)
    _build.check_tensor("v", v, (128, hd), (torch.bfloat16,), dev)
    s = torch.empty((64, 128), dtype=torch.float32, device=dev)
    o = torch.empty((64, -(-hd // 16) * 16), dtype=torch.float32, device=dev)
    err = _build.library().flash_attention_probe_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(), hd,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(err, "flash_attention_probe_kernel")
    return s, o
