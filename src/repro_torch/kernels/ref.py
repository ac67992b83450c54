"""Direct PyTorch oracles for the model kernels (the port's copy of
``repro.kernels.ref``): no chunking, no online softmax, so a kernel bug
cannot hide behind a shared implementation detail."""
from __future__ import annotations

import torch

__all__ = ["flash_attention_ref", "ssd_scan_ref"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Full-materialization attention with GQA, fp32 softmax.
    q (b, sq, h, hd), k/v (b, skv, kv, hd) -> (b, sq, h, hd) in q's dtype."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(skv, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = torch.where(mask[None, None], logits, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, init_state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence over time, fp32.  x (b, s, h, p), dt (b, s, h),
    A (h,), B/C (b, s, h, n), init_state (b, h, p, n) -> (y in x's dtype,
    final state fp32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf, Af = x.float(), dt.float(), B.float(), C.float(), A.float()
    H = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af)
        H = H * decay[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dtf[:, t], Bf[:, t], xf[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], H))
    return torch.stack(ys, dim=1).to(x.dtype), H
