"""The Mamba2 SSD intra-chunk term: the wrapper of the hand-written CUDA
kernels of ``csrc/ssd_scan.cu`` and their plain PyTorch version (the
counterpart of ``repro.kernels.ssd_scan.ssd_intra_chunk``).

Per (head, chunk) of Q positions, in fp32::

    cs      = cumsum(dt · A)
    y_intra = ((C Bᵀ) ⊙ tril(exp(cs_i − cs_j)) ⊙ dt_j) X        (Q, p)
    state   = Xᵀ (B ⊙ dt ⊙ exp(cs_Q − cs))                      (p, n)

``ssd_intra_chunk`` launches a kernel on a CUDA tensor or raises; on a CPU
tensor it runs ``ssd_intra_chunk_plain``.  The dtype picks the kernel:
bfloat16 runs ``ssd_intra_chunk_kernel`` (tensor cores through ``wgmma``,
the chunk loaded by TMA; chunk a multiple of 64, p and n multiples of 16 up
to 128, 16-byte aligned tensors: ``check_bf16_domain``), float32 runs
``ssd_intra_chunk_fp32_kernel`` (CUDA cores, which keep the reference's
fp32 products).  It counts its launches in ``ssd_intra_chunk.launches``.
The inter-chunk state scan stays in PyTorch ops (``ops.ssd_scan``), as the
reference keeps it in jnp.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["MAX_HEADDIM", "bf16_smem_bytes", "check_bf16_domain", "ssd_intra_chunk",
           "ssd_intra_chunk_plain", "ssd_wgmma_layout_probe"]

# fp32: p / 16 output columns per thread, at most 8; bf16: p and n in 8
# slabs of 16 columns at most
MAX_HEADDIM = 128
SMEM_LIMIT = 232448  # shared memory one block can have on the H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bf16_smem_bytes(chunk: int, p: int, n: int, stages: int = 1) -> int:
    """Shared memory of the bf16 kernel with ``stages`` chunk buffers
    (``bf16_smem_bytes`` in ``csrc/ssd_scan.cu``): per stage the chunk's C,
    B and X in bf16, its dt, cs and the state's weights in fp32 and three
    mbarriers; 1024 bytes of alignment slack.  The kernel takes two stages
    where they fit, else one."""
    return stages * (chunk * 2 * (2 * n + p) + 12 * chunk + 24) + 1024


def check_bf16_domain(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                      chunk: int) -> None:
    """Raise unless ``ssd_intra_chunk_kernel`` takes these operands (bf16 x,
    B and C, fp32 dt): chunk a multiple of 64 (the 64-row tiles of
    ``wgmma``), p and n multiples of 16 up to 128 (slabs of 16 columns, one
    TMA box and one ``wgmma`` k-step each), one chunk's operands within a
    block's shared memory, and 16-byte aligned tensors for the TMA
    (contiguous rows of p and n bf16, and a chunk's dt, are then 16-byte
    strides)."""
    p, n = x.shape[-1], B.shape[-1]
    if chunk % 64:
        raise ValueError(f"ssd_intra_chunk_kernel takes bf16 chunks of a multiple of 64 "
                         f"rows, got chunk={chunk}")
    for name, d in (("p", p), ("n", n)):
        if d % 16 or not 16 <= d <= MAX_HEADDIM:
            raise ValueError(f"ssd_intra_chunk_kernel takes bf16 {name} a multiple of 16 up "
                             f"to {MAX_HEADDIM}, got {name}={d}")
    if bf16_smem_bytes(chunk, p, n) > SMEM_LIMIT:
        raise ValueError(f"ssd_intra_chunk_kernel needs {bf16_smem_bytes(chunk, p, n)} bytes "
                         f"of shared memory at chunk={chunk}, p={p}, n={n}; a block has "
                         f"{SMEM_LIMIT}")
    for name, t in (("x", x), ("dt", dt), ("B", B), ("C", C)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for the TMA "
                             f"(data_ptr {t.data_ptr():#x})")


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
    Launches ``ssd_intra_chunk_kernel`` (bf16: one block per chunk and
    head) or ``ssd_intra_chunk_fp32_kernel`` (fp32: one block per 64-row
    tile, chunk and head, plus one per chunk and head for the state) on a
    CUDA tensor; runs ``ssd_intra_chunk_plain`` on a CPU tensor."""
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
    if x.dtype == torch.bfloat16:
        check_bf16_domain(x, dt, B, C, chunk)
    elif p > MAX_HEADDIM:
        raise ValueError(f"ssd_intra_chunk_fp32_kernel takes p <= {MAX_HEADDIM}, got {p}")
    y = torch.empty((bh, s, p), dtype=torch.float32, device=dev)
    states = torch.empty((bh, s // chunk, p, n), dtype=torch.float32, device=dev)
    err = _build.library().ssd_intra_chunk_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), states.data_ptr(), bh, s, p, n, chunk, _DTYPES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(err, "ssd_intra_chunk_kernel" if x.dtype == torch.bfloat16
                          else "ssd_intra_chunk_fp32_kernel")
    ssd_intra_chunk.launches += 1
    return y, states


ssd_intra_chunk.launches = 0


def ssd_wgmma_layout_probe(C: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                           W: torch.Tensor, w: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 kernel's fragment layouts, checked on the card: C and B
    (64, n), X (64, p) contiguous bf16, W (64, 64) and w (64,) fp32 CUDA
    tensors -> (s, y, st) fp32, where s (64, 64) = C Bᵀ, y (64, p) =
    (hi + lo)(W) X and st (p, n) = (hi + lo)(X ⊙ w)ᵀ B, with hi = bf16(v) and
    lo = bf16(v − hi) of each fp32 operand v, computed with the kernel's
    loads, descriptors and products, and each accumulator register written
    at the row and column the kernel assumes it holds.  Not counted in
    ``ssd_intra_chunk.launches``."""
    dev = C.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_wgmma_layout_probe runs on a CUDA tensor, got {dev}")
    n, p = C.shape[-1], X.shape[-1]
    _build.check_tensor("C", C, (64, n), (torch.bfloat16,), dev)
    _build.check_tensor("B", B, (64, n), (torch.bfloat16,), dev)
    _build.check_tensor("X", X, (64, p), (torch.bfloat16,), dev)
    _build.check_tensor("W", W, (64, 64), (torch.float32,), dev)
    _build.check_tensor("w", w, (64,), (torch.float32,), dev)
    check_bf16_domain(X, w, B, C, 64)
    s = torch.empty((64, 64), dtype=torch.float32, device=dev)
    y = torch.empty((64, p), dtype=torch.float32, device=dev)
    st = torch.empty((p, n), dtype=torch.float32, device=dev)
    err = _build.library().ssd_probe_launch(
        C.data_ptr(), B.data_ptr(), X.data_ptr(), W.data_ptr(), w.data_ptr(), s.data_ptr(),
        y.data_ptr(), st.data_ptr(), p, n, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(err, "ssd_probe_kernel")
    return s, y, st
