"""Forward attention with an online softmax: the wrapper of the hand-written
CUDA kernels of ``csrc/flash_attention.cu`` and their plain PyTorch version
(the counterpart of ``repro.kernels.flash_attention.flash_attention_fwd``).

Layout is the reference kernel's: q (b, h, sq, hd), k and v (b, kv, skv, hd),
with GQA through the head index (KV head = h // (h / kv)) and causal masking
on absolute positions (query i sits at ``q_offset + i``).  Unlike the
reference kernel, any sq and skv are taken (a ragged tail is masked) and hd
is not padded outside the kernel.

``flash_attention_fwd`` launches a kernel on a CUDA tensor or raises; on a
CPU tensor it runs ``flash_attention_plain``.  With ``return_lse`` it also
returns each query row's log-sum-exp (fp32, (b, h, sq)), which the
backward takes.  The dtype picks the kernel:
bfloat16 runs ``flash_attention_kernel`` (tensor cores through ``wgmma``, K
and V streamed by TMA; hd a multiple of 8, 16-byte aligned tensors and
strides), float32 runs ``flash_attention_fp32_kernel`` (CUDA cores, which
keep the reference's fp32 products).  Any strides over the first three
dimensions and a contiguous last one are taken: the model's (b, s, h, hd)
tensors pass as ``.transpose(1, 2)`` views without a copy.  It counts its
launches in ``flash_attention_fwd.launches``.

The gradient: ``flash_attention`` is the differentiable entry point, a
``torch.autograd.Function`` when an input needs a gradient.  Its forward
keeps the lse; its backward is ``flash_attention_bwd``, which on a CUDA
tensor launches the hand-written backward kernels of the same source
(``flash_attention_bwd_launch``: D = rowsum(do o), then dK/dV, then dQ; no
atomics) and counts one in ``flash_attention_bwd.launches`` per call, and
on a CPU tensor runs ``flash_attention_bwd_plain``.  bfloat16 runs
``flash_attention_bwd_dkdv_bf16_kernel`` and ``_dq_bf16_kernel`` (tensor
cores through ``wgmma``, tiles streamed by TMA; its domain is the bf16
forward's, ``check_bf16_bwd_domain``, and a tensor outside it raises),
float32 ``flash_attention_bwd_dkdv_kernel`` and ``_dq_kernel`` (CUDA
cores).  The JAX package has no counterpart: its trainer differentiates
its jnp attention.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["NEG_INF", "MAX_HEAD_DIM", "check_bf16_bwd_domain", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_plain", "flash_attention_fwd",
           "flash_attention_plain", "flash_attention_plain_lse", "wgmma_bwd_layout_probe",
           "wgmma_layout_probe"]

NEG_INF = -1e30
MAX_HEAD_DIM = 128  # bf16: 8 slabs of 16 columns; fp32: hd / 16 columns per thread
ROW_PAD = 64  # the bf16 backward keeps D and lse log2(e) in rows padded to this
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int, scale: float
            ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """fp32 scores of the pre-scaled query against the group's keys
    (b, h, sq, skv), and the causal mask (True where a key is hidden) or
    None."""
    sq, skv = q.shape[2], k.shape[2]
    kf = k.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.matmul(q.float() * scale, kf.transpose(-1, -2))
    if not causal:
        return s, None
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    return s, qpos[:, None] < kpos[None, :]


def flash_attention_plain_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True, q_offset: int = 0,
                              scale: float | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch ops: fp32 scores of the pre-scaled
    query, logits masked to -1e30, softmax statistics in fp32, the
    denominator clamped at 1e-30, the output in q's dtype; and each query
    row's log-sum-exp m + log(l), fp32 (b, h, sq)."""
    hd = q.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    s, mask = _scores(q, k, causal, q_offset, scale)
    if mask is not None:
        s = s.masked_fill(mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    vf = v.float().repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    out = (torch.matmul(p, vf) / l).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, q_offset: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """``flash_attention_plain_lse``'s output alone."""
    return flash_attention_plain_lse(q, k, v, causal, q_offset, scale)[0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True, q_offset: int = 0,
                              scale: float | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in PyTorch ops, in fp32: D = rowsum(do
    o), P = exp(scale q k^T - lse) with the masked entries 0, dV = P^T do
    and dK = scale dS^T q summed over each KV group's query heads,
    dS = P (do v^T - D), dQ = scale dS k.  Returns (dq in q's dtype, dk and
    dv in k's)."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    s, mask = _scores(q, k, causal, q_offset, scale)
    p = torch.exp(s - lse.float()[..., None])
    if mask is not None:
        p = p.masked_fill(mask, 0.0)
    dof = do.float()
    d = (dof * o.float()).sum(dim=-1, keepdim=True)
    vf = v.float().repeat_interleave(rep, dim=1)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - d)
    kf = k.float().repeat_interleave(rep, dim=1)
    dq = torch.matmul(ds, kf) * scale
    dk = (torch.matmul(ds.transpose(-1, -2), q.float()) * scale).view(b, kvh, rep, skv, hd)
    dv = torch.matmul(p.transpose(-1, -2), dof).view(b, kvh, rep, skv, hd)
    return dq.to(q.dtype), dk.sum(dim=2).to(k.dtype), dv.sum(dim=2).to(k.dtype)


def _tma_problem(name: str, t: torch.Tensor) -> str | None:
    """Why the TMA cannot read or write the bf16 tensor ``t``, or None: it
    needs a 16-byte aligned base and (batch, head, seq) strides of positive
    multiples of 16 bytes (a dimension of size 1 is never stepped)."""
    if t.data_ptr() % 16:
        return f"{name} must start on a 16-byte boundary for the TMA (data_ptr {t.data_ptr():#x})"
    for i in range(3):
        st = t.stride(i)
        if t.shape[i] > 1 and (st <= 0 or (2 * st) % 16):
            return (f"{name} has stride {st} elements in dimension {i}: the TMA needs a positive "
                    f"multiple of 16 bytes")
    return None


def _tma_strides(name: str, t: torch.Tensor) -> list[int]:
    """(batch, head, seq) strides of a bf16 tensor in elements, as the TMA
    takes them (``_tma_problem`` raises as ``ValueError``); a dimension of
    size 1 is never stepped, so its stride is set to a legal value."""
    problem = _tma_problem(name, t)
    if problem:
        raise ValueError(problem)
    return [t.stride(i) if t.shape[i] > 1 else t.shape[-1] for i in range(3)]


def check_bf16_bwd_domain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                          do: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
                          dv: torch.Tensor) -> list[int]:
    """Raise ``ValueError`` unless the bf16 backward kernels take these
    (b, heads, seq, hd) tensors, the inputs and the outputs: hd a multiple
    of 8 up to 128 (slabs of 16 columns, one TMA box and one ``wgmma``
    k-step each; a partial slab is zero-filled), a contiguous last
    dimension, and the TMA's terms for each (``_tma_problem``).  The bf16
    forward has the same domain, so no training input falls outside it.
    Returns the 24 (batch, head, seq) strides in elements that the launcher
    takes.  Reads only shapes, strides and addresses: runs on any device."""
    hd = q.shape[-1]
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"the bf16 attention backward takes hd a multiple of 8 up to "
                         f"{MAX_HEAD_DIM} (wgmma widths, 16-byte TMA strides), got hd={hd}")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do), ("dq", dq), ("dk", dk),
                    ("dv", dv)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
        strides += _tma_strides(name, t)
    return strides


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0,
                        scale: float | None = None, return_lse: bool = False):
    """Attention over (b, h, sq, hd) queries and (b, kv, skv, hd) keys and
    values -> (b, h, sq, hd) in q's dtype, and with ``return_lse`` also the
    rows' log-sum-exp (fp32, (b, h, sq)).  ``scale`` defaults to
    ``hd ** -0.5``.  Launches ``flash_attention_kernel`` (bf16: one resident
    block per SM walking the 128-query tiles of every head) or
    ``flash_attention_fp32_kernel`` (fp32: one block per 64-query tile) on a
    CUDA tensor; runs ``flash_attention_plain_lse`` on a CPU tensor."""
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
        out, lse = flash_attention_plain_lse(q, k, v, causal, q_offset, scale)
        return (out, lse) if return_lse else out
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
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) if return_lse else None
    err = _build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), strides,
        b, h, kvh, sq, skv, hd, _DTYPES[q.dtype], int(bool(causal)), int(q_offset),
        scale, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(err, "flash_attention_kernel")
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                        q_offset: int = 0, scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention_fwd`` at (q, k, v), given its output
    ``o``, its ``lse`` and the output's gradient ``do`` (all (b, heads, seq,
    hd) with any strides over the first three dimensions) -> (dq, dk, dv),
    dq in q's dtype and (b, sq, h, hd) memory order, dk and dv in k's dtype
    and (b, skv, kv, hd) order, each seen as (b, heads, seq, hd).  Launches
    the backward kernels on a CUDA tensor (bfloat16: the tensor-core
    kernels, within ``check_bf16_bwd_domain``; float32: the CUDA-core
    kernels, hd up to 128); runs ``flash_attention_bwd_plain`` on a CPU
    tensor."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    dev = q.device
    _build.check_tensor("q", q, (b, h, sq, hd), (q.dtype,), dev, contiguous=False)
    for name, t in (("k", k), ("v", v)):
        _build.check_tensor(name, t, (b, kvh, skv, hd), (q.dtype,), dev, contiguous=False)
    for name, t in (("o", o), ("do", do)):
        _build.check_tensor(name, t, (b, h, sq, hd), (q.dtype,), dev, contiguous=False)
    _build.check_tensor("lse", lse, (b, h, sq), (torch.float32,), dev)
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    scale = hd ** -0.5 if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, q_offset, scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on a CUDA or CPU tensor, got {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the attention backward kernel takes float32 or bfloat16, got {q.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"the attention backward kernel takes hd <= {MAX_HEAD_DIM}, got {hd}")
    if skv == 0:
        raise ValueError("flash_attention_bwd needs at least one key")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
    dq = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    dk = torch.empty((b, skv, kvh, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    dv = torch.empty((b, skv, kvh, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    if q.dtype == torch.bfloat16:
        st = check_bf16_bwd_domain(q, k, v, o, do, dq, dk, dv)
        # D and lse log2(e) in rows padded to ROW_PAD, one bulk copy a tile
        d_rows = torch.empty((2, b * h * (-(-sq // ROW_PAD) * ROW_PAD)), dtype=torch.float32,
                             device=dev)
    else:
        st = [t.stride(i) for t in (q, k, v, o, do, dq, dk, dv) for i in range(3)]
        d_rows = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 24)(*st)
    err = _build.library().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), d_rows.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        strides, b, h, kvh, sq, skv, hd, _DTYPES[q.dtype], int(bool(causal)), int(q_offset),
        scale, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(err, "flash_attention_bwd_kernel")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the forward kernel (keeping the lse) and
    the backward kernels, or their plain versions on a CPU tensor."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, q_offset, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, q_offset, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        # the kernels read do with a unit last stride, and the bf16 ones by
        # TMA (a broadcast gradient's 0 strides are copied out first)
        if do.stride(-1) != 1 or (do.is_cuda and do.dtype == torch.bfloat16
                                  and _tma_problem("do", do)):
            do = do.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    q_offset: int = 0, scale: float | None = None) -> torch.Tensor:
    """``flash_attention_fwd``, differentiable: where autograd records and an
    input needs a gradient, through ``_FlashAttention`` (the forward keeps
    its lse for ``flash_attention_bwd``); else the forward alone, as serving
    calls it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, q_offset, scale)
    return flash_attention_fwd(q, k, v, causal, q_offset, scale)


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


def wgmma_bwd_layout_probe(q: torch.Tensor, do: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 backward kernels' fragment layouts, checked on the card: q
    and do (64, hd), k and v (128, hd) contiguous bf16 CUDA tensors -> (s,
    dp, dv, dk) fp32, where s = k q^T and dp = v do^T (128, 64), dv =
    bf16(s) do and dk = bf16(dp) q (128, 16 ceil(hd / 16)) are computed by
    two warpgroups of 64 keys with the dK/dV kernel's loads, descriptors and
    products (K and V as A operands from a 128-row tile, Q and dO as n64
    K-major B operands, then as MN-major B operands under a register A; the
    dQ kernel's products take the same layouts), each accumulator register
    written at the row and column the kernels assume it holds.  Not counted
    in ``flash_attention_bwd.launches``."""
    hd = q.shape[-1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"wgmma_bwd_layout_probe runs on a CUDA tensor, got {dev}")
    for name, t, rows in (("q", q, 64), ("do", do, 64), ("k", k, 128), ("v", v, 128)):
        _build.check_tensor(name, t, (rows, hd), (torch.bfloat16,), dev)
    hdp = -(-hd // 16) * 16
    s, dp = (torch.empty((128, 64), dtype=torch.float32, device=dev) for _ in range(2))
    dv, dk = (torch.empty((128, hdp), dtype=torch.float32, device=dev) for _ in range(2))
    err = _build.library().flash_attention_bwd_probe_launch(
        q.data_ptr(), do.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), dp.data_ptr(),
        dv.data_ptr(), dk.data_ptr(), hd, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(err, "flash_attention_bwd_probe_kernel")
    return s, dp, dv, dk
