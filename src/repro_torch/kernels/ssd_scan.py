"""The Mamba2 SSD intra-chunk term: the wrapper of the hand-written CUDA
kernel ``ssd_intra_chunk_kernel`` (``csrc/ssd_scan.cu``) and its plain
PyTorch version (the counterpart of ``repro.kernels.ssd_scan.ssd_intra_chunk``).

Per (head, chunk) of Q positions, in fp32::

    cs      = cumsum(dt · A)
    y_intra = ((C Bᵀ) ⊙ tril(exp(cs_i − cs_j)) ⊙ dt_j) X        (Q, p)
    state   = Xᵀ (B ⊙ dt ⊙ exp(cs_Q − cs))                      (p, n)

``ssd_intra_chunk`` launches the kernel on a CUDA tensor or raises; on a
CPU tensor it runs ``ssd_intra_chunk_plain``.  It counts its launches in
``ssd_intra_chunk.launches``.  The inter-chunk state scan stays in PyTorch
ops (``ops.ssd_scan``), as the reference keeps it in jnp.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["MAX_HEADDIM", "ssd_intra_chunk", "ssd_intra_chunk_plain"]

MAX_HEADDIM = 128  # the kernel keeps p / 16 output columns per thread, at most 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_intra_chunk_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, chunk: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch ops, every chunk at once.
    x (bh, s, p), dt (bh, s), A (bh, 1), B/C (bh, s, n) ->
    (y_intra (bh, s, p) fp32, states (bh, s / chunk, p, n) fp32)."""
    bh, s, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xf = x.float().reshape(bh, nc, chunk, p)
    dtc = dt.float().reshape(bh, nc, chunk)
    Bf = B.float().reshape(bh, nc, chunk, n)
    Cf = C.float().reshape(bh, nc, chunk, n)
    cs = torch.cumsum(dtc * A.float().reshape(bh, 1, 1), dim=-1)  # (bh, nc, Q)
    scores = torch.matmul(Cf, Bf.transpose(-1, -2))  # (bh, nc, Q, Q)
    tril = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    L = torch.where(tril, torch.exp(cs[..., :, None] - cs[..., None, :]), 0.0)
    w = scores * L * dtc[..., None, :]
    y = torch.matmul(w, xf).reshape(bh, s, p)
    bw = Bf * (torch.exp(cs[..., -1:] - cs) * dtc)[..., None]
    states = torch.matmul(xf.transpose(-1, -2), bw)  # (bh, nc, p, n)
    return y, states


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (bh, s, p) and B/C (bh, s, n) in fp32 or bf16 (one dtype), dt (bh, s)
    and A (bh, 1) fp32, s a multiple of ``chunk`` ->
    (y_intra (bh, s, p) fp32, states (bh, s / chunk, p, n) fp32).
    Launches ``ssd_intra_chunk_kernel`` on a CUDA tensor (one block per
    64-row tile, chunk and head, plus one per chunk and head for the state);
    runs ``ssd_intra_chunk_plain`` on a CPU tensor."""
    if x.dim() != 3 or B.dim() != 3:
        raise ValueError(f"ssd_intra_chunk takes (bh, s, p) and (bh, s, n) tensors, "
                         f"got {tuple(x.shape)} and {tuple(B.shape)}")
    bh, s, p = x.shape
    n = B.shape[-1]
    if chunk <= 0 or s % chunk:
        raise ValueError(f"s={s} is not a multiple of chunk={chunk}")
    dev = x.device
    _build.check_tensor("x", x, (bh, s, p), tuple(_DTYPES), dev)
    _build.check_tensor("B", B, (bh, s, n), (x.dtype,), dev)
    _build.check_tensor("C", C, (bh, s, n), (x.dtype,), dev)
    _build.check_tensor("dt", dt, (bh, s), (torch.float32,), dev)
    _build.check_tensor("A", A, (bh, 1), (torch.float32,), dev)
    if dev.type == "cpu":
        return ssd_intra_chunk_plain(x, dt, A, B, C, chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_intra_chunk runs on a CUDA or CPU tensor, got {dev}")
    if p > MAX_HEADDIM:
        raise ValueError(f"ssd_intra_chunk_kernel takes p <= {MAX_HEADDIM}, got {p}")
    y = torch.empty((bh, s, p), dtype=torch.float32, device=dev)
    states = torch.empty((bh, s // chunk, p, n), dtype=torch.float32, device=dev)
    err = _build.library().ssd_intra_chunk_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), states.data_ptr(), bh, s, p, n, chunk, _DTYPES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(err, "ssd_intra_chunk_kernel")
    ssd_intra_chunk.launches += 1
    return y, states


ssd_intra_chunk.launches = 0
