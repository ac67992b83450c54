"""Dispatch wrappers around the model kernels (the counterpart of
``repro.kernels.ops``): layout (b, s, h, hd) <-> (b, h, s, hd) for
attention, and the inter-chunk state scan that completes the SSD algorithm
around the intra-chunk kernel.

Unlike the reference, the head dim is not padded to 128 (the TPU's lane
width): the kernel takes the true hd, scaled by ``hd ** -0.5``.  Each
wrapper runs the kernel on a CUDA tensor and its plain version on a CPU
tensor (see ``flash_attention_fwd`` and ``ssd_intra_chunk``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import flash_attention as _fa
from . import ssd_scan as _ssd

__all__ = ["flash_attention", "ssd_scan"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Flash attention with GQA: q (b, sq, h, hd), k/v (b, skv, kv, hd) ->
    (b, sq, h, hd) in q's dtype; differentiable (``_fa.flash_attention``:
    the backward kernels on a CUDA tensor)."""
    hd = q.shape[-1]
    o = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal, q_offset=q_offset, scale=hd ** -0.5)
    return o.transpose(1, 2)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: int, init_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full SSD: the intra-chunk kernel, then the inter-chunk state scan and
    the cross-chunk output term in PyTorch ops; differentiable
    (``_ssd.ssd_intra_chunk``: the backward kernel on a CUDA tensor, the
    inter-chunk scan under autograd).  x (b, s, h, p), dt (b, s, h),
    A (h,), B/C (b, s, h, n), init_state (b, h, p, n) ->
    (y (b, s, h, p) fp32, final state (b, h, p, n) fp32)."""
    b, s_orig, h, p = x.shape
    n = B.shape[-1]
    pad = (-s_orig) % chunk
    if pad:  # dt = 0 on padding: identity transition, zero contribution
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    s = x.shape[1]
    nc = s // chunk

    # (b, s, h, ...) -> (b*h, s, ...)
    xr = x.transpose(1, 2).reshape(b * h, s, p).contiguous()
    dtr = dt.transpose(1, 2).reshape(b * h, s).float().contiguous()
    Ar = A.float()[None, :].expand(b, h).reshape(b * h, 1).contiguous()
    Br = B.transpose(1, 2).reshape(b * h, s, n).contiguous()
    Cr = C.transpose(1, 2).reshape(b * h, s, n).contiguous()

    y_intra, states = _ssd.ssd_intra_chunk(xr, dtr, Ar, Br, Cr, chunk)

    # inter-chunk state scan (linear, cheap) + cross-chunk output term
    cs = torch.cumsum((dtr * Ar).reshape(b * h, nc, chunk), dim=-1)  # (bh, nc, Q)
    seg_end = cs[..., -1]  # (bh, nc)
    H = (torch.zeros((b * h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float().reshape(b * h, p, n))
    H_ins = []
    for z in range(nc):
        H_ins.append(H)
        H = H * torch.exp(seg_end[:, z])[:, None, None] + states[:, z]
    H_ins = torch.stack(H_ins, dim=1)  # (bh, nc, p, n): state entering each chunk

    Crc = Cr.float().reshape(b * h, nc, chunk, n)
    y_inter = torch.einsum("gzqn,gzpn->gzqp", Crc, H_ins) * torch.exp(cs)[..., None]
    y = y_intra.reshape(b * h, nc, chunk, p) + y_inter
    y = y.reshape(b, h, s, p).transpose(1, 2)
    return y[:, :s_orig], H.reshape(b, h, p, n)
