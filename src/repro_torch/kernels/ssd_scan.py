"""The Mamba2 SSD intra-chunk term and its gradient: the wrappers of the
hand-written CUDA kernels of ``csrc/ssd_scan.cu`` and ``csrc/ssd_scan_bwd.cu``
and their plain PyTorch versions (the counterpart of
``repro.kernels.ssd_scan.ssd_intra_chunk``).

Per (head, chunk) of Q positions, in fp32::

    cs      = cumsum(dt · A)
    y_intra = ((C Bᵀ) ⊙ tril(exp(cs_i − cs_j)) ⊙ dt_j) X        (Q, p)
    state   = Xᵀ (B ⊙ dt ⊙ exp(cs_Q − cs))                      (p, n)

``ssd_intra_chunk`` is the differentiable entry point.  Its forward
launches a kernel on a CUDA tensor or raises; on a CPU tensor it runs
``ssd_intra_chunk_plain``.  The dtype picks the kernel: bfloat16 runs
``ssd_intra_chunk_kernel`` (tensor cores through ``wgmma``, the chunk
loaded by TMA; chunk a multiple of 64, p and n multiples of 16 up to 128,
16-byte aligned tensors: ``check_bf16_domain``), float32 runs
``ssd_intra_chunk_fp32_kernel`` (CUDA cores, which keep the reference's
fp32 products).  It counts its launches in ``ssd_intra_chunk.launches``.

Where autograd records and an input needs a gradient, the forward runs
inside ``_SsdIntraChunk``, whose backward is ``ssd_intra_chunk_bwd``: on a
CUDA tensor it launches, by dtype and shape, ``ssd_bwd_col_bf16_kernel``
and ``ssd_bwd_row_bf16_kernel`` (bf16 within ``check_bf16_bwd_domain``:
tensor cores through ``wgmma``, fp32 operands split into bf16 terms) or
``ssd_intra_chunk_bwd_kernel`` (fp32, and bf16 outside that domain: CUDA
cores; p and n up to 128: ``check_bwd_domain``), then
``ssd_intra_chunk_bwd_finish_kernel``, with no atomics, and counts one in
``ssd_intra_chunk_bwd.launches`` per call (and in ``.bf16_launches`` when
the tensor-core passes took it); on a CPU tensor it runs
``ssd_intra_chunk_bwd_plain``.  Both take exp(cs_i − cs_j) on the causal
triangle only, where it is at most 1: above it the exponent grows with the
chunk and overflows fp32 (past 88.7) at the configs' chunk of 256, and
autograd through the masked forward then gives NaN to dt and A.  The JAX
package has no counterpart: it differentiates its jnp
``repro.models.ssm.ssd_chunked_ref``.  The inter-chunk state scan stays in
PyTorch ops under autograd (``ops.ssd_scan``), as the reference keeps it
in jnp.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["MAX_HEADDIM", "bf16_bwd_domain_error", "bf16_bwd_smem_bytes", "bf16_smem_bytes",
           "bwd_kernel", "bwd_smem_bytes", "check_bf16_bwd_domain", "check_bf16_domain",
           "check_bwd_domain", "ssd_bwd_wgmma_layout_probe", "ssd_intra_chunk",
           "ssd_intra_chunk_bwd", "ssd_intra_chunk_bwd_plain", "ssd_intra_chunk_plain",
           "ssd_wgmma_layout_probe"]

# fp32: p / 16 output columns per thread, at most 8; bf16: p and n in 8
# slabs of 16 columns at most
MAX_HEADDIM = 128
BWD_TILE = 64  # rows of the backward's row and column tiles
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


def _bwd_cols(d: int) -> int:
    """Columns the backward kernel keeps of a width ``d``: 16 times the
    least of 1, 2, 4, 8 that covers ``d / 16`` (its instantiations)."""
    per = 1
    while 16 * per < d:
        per *= 2
    return 16 * per


def bwd_smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory of ``ssd_intra_chunk_bwd_kernel`` (``bwd_smem_bytes``
    in ``csrc/ssd_scan_bwd.cu``): the chunk's cs (fp64) and dt, a (16, 64)
    fp64 tile of partial column sums, a column tile's two state terms, two
    (64, n) and two (64, p) fp32 tiles, their columns padded to
    ``_bwd_cols`` plus one, and two (64, 65) fp32 tiles of W and dS."""
    t = BWD_TILE
    return (12 * chunk + 8 * 16 * t + 4 * 2 * t
            + 4 * (2 * t * (_bwd_cols(n) + 1) + 2 * t * (_bwd_cols(p) + 1) + 2 * t * (t + 1)))


def check_bwd_domain(bh: int, s: int, p: int, n: int, chunk: int) -> None:
    """Raise ``ValueError`` unless ``ssd_intra_chunk_bwd_kernel`` takes this
    shape (either dtype): p and n from 1 to 128 (at most 8 columns of 16 a
    thread), the chunk's cs, dt and tiles within a block's shared memory,
    and grid dimensions within CUDA's 65535 (heads, chunks).  Device-free:
    the wrapper calls it before any launch, and nothing falls back."""
    if chunk <= 0 or s % chunk:
        raise ValueError(f"s={s} is not a multiple of chunk={chunk}")
    for name, d in (("p", p), ("n", n)):
        if not 1 <= d <= MAX_HEADDIM:
            raise ValueError(f"ssd_intra_chunk_bwd_kernel takes {name} from 1 to "
                             f"{MAX_HEADDIM}, got {name}={d}")
    if bwd_smem_bytes(chunk, p, n) > SMEM_LIMIT:
        raise ValueError(f"ssd_intra_chunk_bwd_kernel needs {bwd_smem_bytes(chunk, p, n)} "
                         f"bytes of shared memory at chunk={chunk}, p={p}, n={n}; a block "
                         f"has {SMEM_LIMIT}")
    if bh > 65535 or s // chunk > 65535:
        raise ValueError(f"ssd_intra_chunk_bwd_kernel takes at most 65535 heads and chunks, "
                         f"got bh={bh}, chunks={s // chunk}")


def bf16_bwd_smem_bytes(chunk: int, p: int, n: int) -> tuple[int, int]:
    """Shared memory of the bf16 backward's column and row passes
    (``ColLayout``/``RowLayout::bytes`` in ``csrc/ssd_scan_bwd.cu``), p and
    n padded to 64 or 128 columns, in 64-row slabs of 2 KB.  Column pass: B_j and X_j, the chunk's dt, cs (fp64) and its
    fp32 offsets from each tile's start (rounded to 256 bytes), two ring
    stages of C_i and gy_i's three terms, 4 KB of G's column sums, the
    mbarriers and 256 bytes of alignment slack.  Row pass: gy_i's two terms,
    dt, cs and the offsets, two stages of B_j and X_j, the same."""
    sp, sn = (4 if d <= 64 else 8 for d in (p, n))
    slab = BWD_TILE * 32
    rounded = lambda v: (v + 255) // 256 * 256
    col = rounded((sn + sp) * slab + 16 * chunk) + 2 * (sn + 3 * sp) * slab + 4096 + 64 + 256
    row = rounded(2 * sp * slab + 16 * chunk) + 2 * (sn + sp) * slab + 64 + 256
    return col, row


def bf16_bwd_domain_error(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                          gy: torch.Tensor, gst: torch.Tensor, chunk: int) -> str | None:
    """Why the bf16 backward (``ssd_bwd_col_bf16_kernel`` and
    ``ssd_bwd_row_bf16_kernel``) does not take these operands, or None:
    bf16 x, B and C; chunk a multiple of 64 (the 64-row tiles of
    ``wgmma``); p and n multiples of 16 up to 128 (slabs of 16 columns, one
    TMA box and one ``wgmma`` k-step each); both passes within a block's
    shared memory; 16-byte aligned x, dt, B, C, gy and gst (the TMA's and
    the 16-byte loads' terms).  Device-free: the wrapper asks before any
    launch."""
    p, n = x.shape[-1], B.shape[-1]
    if x.dtype != torch.bfloat16:
        return f"ssd_bwd_col_bf16_kernel takes bf16 x, B and C, got {x.dtype}"
    if chunk % 64:
        return (f"ssd_bwd_col_bf16_kernel takes chunks of a multiple of 64 rows, "
                f"got chunk={chunk}")
    for name, d in (("p", p), ("n", n)):
        if d % 16 or not 16 <= d <= MAX_HEADDIM:
            return (f"ssd_bwd_col_bf16_kernel takes {name} a multiple of 16 up to "
                    f"{MAX_HEADDIM}, got {name}={d}")
    need = max(bf16_bwd_smem_bytes(chunk, p, n))
    if need > SMEM_LIMIT:
        return (f"ssd_bwd_col_bf16_kernel needs {need} bytes of shared memory at chunk={chunk}, "
                f"p={p}, n={n}; a block has {SMEM_LIMIT}")
    for name, t in (("x", x), ("dt", dt), ("B", B), ("C", C), ("gy", gy), ("gst", gst)):
        if t.data_ptr() % 16:
            return (f"{name} must start on a 16-byte boundary for ssd_bwd_col_bf16_kernel "
                    f"(data_ptr {t.data_ptr():#x})")
    return None


def check_bf16_bwd_domain(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                          gy: torch.Tensor, gst: torch.Tensor, chunk: int) -> None:
    """Raise ``ValueError`` with ``bf16_bwd_domain_error``'s reason unless the
    bf16 backward takes these operands."""
    err = bf16_bwd_domain_error(x, dt, B, C, gy, gst, chunk)
    if err is not None:
        raise ValueError(err)


def bwd_kernel(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               gy: torch.Tensor, gst: torch.Tensor, chunk: int) -> str:
    """The kernel ``ssd_intra_chunk_bwd`` launches for these CUDA operands,
    chosen by dtype, shape and alignment before any launch:
    ``ssd_bwd_col_bf16_kernel`` (with ``ssd_bwd_row_bf16_kernel``) within
    the bf16 domain, else ``ssd_intra_chunk_bwd_kernel``."""
    if bf16_bwd_domain_error(x, dt, B, C, gy, gst, chunk) is None:
        return "ssd_bwd_col_bf16_kernel"
    return "ssd_intra_chunk_bwd_kernel"


def _causal_exp(cs: torch.Tensor) -> torch.Tensor:
    """L = exp(cs_i − cs_j) on the causal triangle (i ≥ j), 0 above it,
    from cs (..., Q).  exp is taken of the triangle only: above it the
    exponent is positive (dt ≥ 0, A < 0) and overflows fp32 at long
    chunks, and a gradient through ``where(tril, exp(.), 0)`` would be
    0 · inf = NaN there."""
    chunk = cs.shape[-1]
    tril = torch.ones((chunk, chunk), dtype=torch.bool, device=cs.device).tril()
    return torch.exp(torch.where(tril, cs[..., :, None] - cs[..., None, :], -torch.inf))


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic: fp32, as the kernels', or float64 for
    float64 operands."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def ssd_intra_chunk_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, chunk: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch ops, every chunk at once.
    x (bh, s, p), dt (bh, s), A (bh, 1), B/C (bh, s, n) ->
    (y_intra (bh, s, p) fp32, states (bh, s / chunk, p, n) fp32); float64
    operands are computed and returned in float64 (a test's oracle)."""
    bh, s, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    wdt = _work_dtype(x)
    xf = x.to(wdt).reshape(bh, nc, chunk, p)
    dtc = dt.to(wdt).reshape(bh, nc, chunk)
    Bf = B.to(wdt).reshape(bh, nc, chunk, n)
    Cf = C.to(wdt).reshape(bh, nc, chunk, n)
    cs = torch.cumsum(dtc * A.to(wdt).reshape(bh, 1, 1), dim=-1)  # (bh, nc, Q)
    scores = torch.matmul(Cf, Bf.transpose(-1, -2))  # (bh, nc, Q, Q)
    w = scores * _causal_exp(cs) * dtc[..., None, :]
    y = torch.matmul(w, xf).reshape(bh, s, p)
    bw = Bf * (torch.exp(cs[..., -1:] - cs) * dtc)[..., None]
    states = torch.matmul(xf.transpose(-1, -2), bw)  # (bh, nc, p, n)
    return y, states


def ssd_intra_chunk_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                              B: torch.Tensor, C: torch.Tensor, gy: torch.Tensor,
                              gst: torch.Tensor, chunk: int
                              ) -> tuple[torch.Tensor, ...]:
    """The backward kernels' function in PyTorch ops, every chunk at once:
    the gradient of ``ssd_intra_chunk_plain`` at (x, dt, A, B, C) given gy
    (bh, s, p) and gst (bh, s / chunk, p, n), the gradients of y_intra and
    of the states -> (dx, ddt, dA, dB, dC): dx, dB and dC in the inputs'
    dtype, ddt (bh, s) and dA (bh, 1) fp32 (float64 operands: all float64).
    Per chunk, with S = C Bᵀ,
    L = exp(cs_i − cs_j) on the triangle, W = S L dt_j and w_j =
    exp(cs_Q − cs_j) dt_j::

        dW = gy Xᵀ,  dS = dW L dt_j,  G = dW W
        dx = Wᵀ gy + w (B gstᵀ),  dC = dS B,  dB = dSᵀ C + w (X gst)
        u_j = x_j · (gst B_j)
        dcs = rowsum(G) − colsum(G) − w u,  dcs_Q += Σ w u
        ddt = colsum(dW S L) + exp(cs_Q − cs) u + A R,  dA = Σ dt R

    with R_t = Σ_{i ≥ t} dcs_i (cs = cumsum(dt A))."""
    bh, s, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    wdt = _work_dtype(x)
    xf = x.to(wdt).reshape(bh, nc, chunk, p)
    dtc = dt.to(wdt).reshape(bh, nc, chunk)
    Bf = B.to(wdt).reshape(bh, nc, chunk, n)
    Cf = C.to(wdt).reshape(bh, nc, chunk, n)
    g = gy.to(wdt).reshape(bh, nc, chunk, p)
    gs = gst.to(wdt)  # (bh, nc, p, n)
    a = A.to(wdt).reshape(bh, 1, 1)
    # cs in float64: the gradients of dt and A are differences of sums
    # (below), and fp32 cs, which falls to ~-200 over a chunk of 256,
    # moves exp(cs_i − cs_j) by ~1e-5 relative
    f64 = torch.float64
    cs = torch.cumsum(dtc.to(f64) * a.to(f64), dim=-1)  # (bh, nc, Q)
    L = _causal_exp(cs).to(wdt)
    S = torch.matmul(Cf, Bf.transpose(-1, -2))
    dW = torch.matmul(g, xf.transpose(-1, -2))
    Ldt = L * dtc[..., None, :]
    W = S * Ldt
    dS = dW * Ldt
    G = dW * W
    decay = torch.exp(cs[..., -1:] - cs).to(wdt)  # exp(cs_Q − cs_j) <= 1
    w = decay * dtc
    gB = torch.matmul(Bf, gs.transpose(-1, -2))  # (bh, nc, Q, p): gst B_j per row
    dx = torch.matmul(W.transpose(-1, -2), g) + w[..., None] * gB
    dC = torch.matmul(dS, Bf)
    dB = torch.matmul(dS.transpose(-1, -2), Cf) + w[..., None] * torch.matmul(xf, gs)
    u = (xf * gB).sum(-1)
    # dcs sums to 0 over a chunk (each G_ij enters its row and its column),
    # so R and dA are differences of large sums: G's row and column sums, R
    # and dA are taken in float64, as the kernel takes them
    Gd, wu = G.to(f64), (w * u).to(f64)
    dcs = Gd.sum(-1) - Gd.sum(-2) - wu
    dcs[..., -1] += wu.sum(-1)
    R = dcs.flip(-1).cumsum(-1).flip(-1)
    ddt = ((dW * S * L).sum(-2) + decay * u).to(f64) + a.to(f64) * R
    dA = (dtc.to(f64) * R).sum((-1, -2)).reshape(bh, 1)
    return (dx.reshape(bh, s, p).to(x.dtype), ddt.reshape(bh, s).to(wdt), dA.to(wdt),
            dB.reshape(bh, s, n).to(B.dtype), dC.reshape(bh, s, n).to(C.dtype))


def _check_inputs(x, dt, A, B, C, chunk) -> tuple[int, int, int, int]:
    """(bh, s, p, n) of the kernels' operands, or raise."""
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_intra_chunk runs on a CUDA or CPU tensor, got {dev}")
    return bh, s, p, n


def _intra_chunk_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                     C: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward on checked operands: the kernel on a CUDA tensor (counted
    in ``ssd_intra_chunk.launches``), the plain version on a CPU tensor."""
    dev = x.device
    if dev.type == "cpu":
        return ssd_intra_chunk_plain(x, dt, A, B, C, chunk)
    bh, s, p = x.shape
    n = B.shape[-1]
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


def ssd_intra_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                        C: torch.Tensor, gy: torch.Tensor, gst: torch.Tensor, chunk: int
                        ) -> tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_intra_chunk`` at (x, dt, A, B, C) given gy
    (bh, s, p) and gst (bh, s / chunk, p, n) in fp32 -> (dx, ddt, dA, dB,
    dC), dx, dB and dC in x's dtype, ddt (bh, s) and dA (bh, 1) fp32.
    On a CUDA tensor it launches, as ``bwd_kernel`` chooses,
    ``ssd_bwd_col_bf16_kernel`` and ``ssd_bwd_row_bf16_kernel`` (bf16
    within ``check_bf16_bwd_domain``: persistent passes over (head, chunk,
    pair of 64-row tiles) on the tensor cores) or
    ``ssd_intra_chunk_bwd_kernel`` (within ``check_bwd_domain``: one block
    per 64-row tile, chunk and head for the row terms, one per column tile
    for the column terms, CUDA cores), then
    ``ssd_intra_chunk_bwd_finish_kernel`` (the reverse scan of dcs, ddt,
    and dA summed over the chunks in order); on a CPU tensor it runs
    ``ssd_intra_chunk_bwd_plain``."""
    bh, s, p, n = _check_inputs(x, dt, A, B, C, chunk)
    dev = x.device
    _build.check_tensor("gy", gy, (bh, s, p), (torch.float32,), dev)
    _build.check_tensor("gst", gst, (bh, s // chunk, p, n), (torch.float32,), dev)
    if dev.type == "cpu":
        return ssd_intra_chunk_bwd_plain(x, dt, A, B, C, gy, gst, chunk)
    bf16 = bwd_kernel(x, dt, B, C, gy, gst, chunk) == "ssd_bwd_col_bf16_kernel"
    if not bf16:
        check_bwd_domain(bh, s, p, n, chunk)
    dx = torch.empty_like(x)
    dB = torch.empty_like(B)
    dC = torch.empty_like(C)
    ddt = torch.empty((bh, s), dtype=torch.float32, device=dev)
    dA = torch.empty((bh, 1), dtype=torch.float32, device=dev)
    # per row, in fp64: colsum(G) + w u; w u; ddt's direct and state terms;
    # rowsum(G), whole or (bf16) in partials by 64-row column tile (the
    # finish kernel's inputs)
    planes = 3 + (chunk // BWD_TILE if bf16 else 1)
    scratch = torch.empty((planes, bh, s), dtype=torch.float64, device=dev)
    lib = _build.library()
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), gy.data_ptr(),
            gst.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), scratch.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if bf16:
        err = lib.ssd_intra_chunk_bwd_bf16_launch(*ptrs, bh, s, p, n, chunk, stream)
        _build.raise_on_error(err, "ssd_bwd_col_bf16_kernel")
        ssd_intra_chunk_bwd.bf16_launches += 1
    else:
        err = lib.ssd_intra_chunk_bwd_launch(*ptrs, bh, s, p, n, chunk, _DTYPES[x.dtype], stream)
        _build.raise_on_error(err, "ssd_intra_chunk_bwd_kernel")
    ssd_intra_chunk_bwd.launches += 1
    return dx, ddt, dA, dB, dC


ssd_intra_chunk_bwd.launches = 0
ssd_intra_chunk_bwd.bf16_launches = 0


class _SsdIntraChunk(torch.autograd.Function):
    """The intra-chunk term with its gradient: the forward kernel (or its
    plain version on a CPU tensor) and ``ssd_intra_chunk_bwd``."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, states = _intra_chunk_fwd(x, dt, A, B, C, chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y, states

    @staticmethod
    def backward(ctx, gy, gst):
        x, dt, A, B, C = ctx.saved_tensors
        grads = ssd_intra_chunk_bwd(x, dt, A, B, C, gy.float().contiguous(),
                                    gst.float().contiguous(), ctx.chunk)
        return (*grads, None)


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (bh, s, p) and B/C (bh, s, n) in fp32 or bf16 (one dtype), dt (bh, s)
    and A (bh, 1) fp32, s a multiple of ``chunk`` ->
    (y_intra (bh, s, p) fp32, states (bh, s / chunk, p, n) fp32).
    Launches ``ssd_intra_chunk_kernel`` (bf16: one block per chunk and
    head) or ``ssd_intra_chunk_fp32_kernel`` (fp32: one block per 64-row
    tile, chunk and head, plus one per chunk and head for the state) on a
    CUDA tensor; runs ``ssd_intra_chunk_plain`` on a CPU tensor.
    Differentiable: where autograd records and an input needs a gradient,
    through ``_SsdIntraChunk`` (on a CUDA tensor the backward's domain,
    ``check_bwd_domain``, is checked before the forward launches); else the
    forward alone, as serving calls it."""
    bh, s, p, n = _check_inputs(x, dt, A, B, C, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C)):
        if x.is_cuda:
            check_bwd_domain(bh, s, p, n, chunk)
        return _SsdIntraChunk.apply(x, dt, A, B, C, chunk)
    return _intra_chunk_fwd(x, dt, A, B, C, chunk)


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


def ssd_bwd_wgmma_layout_probe(B: torch.Tensor, C: torch.Tensor, X: torch.Tensor,
                               gy: torch.Tensor, gst: torch.Tensor, Wt: torch.Tensor,
                               Dt: torch.Tensor) -> dict:
    """The bf16 backward's fragment layouts, checked on the card: B and C
    (64, n), X (64, p) contiguous bf16, gy (64, p), gst (p, n), Wt and Dt
    (64, 64) contiguous fp32 CUDA tensors, p and n multiples of 16 up to 128
    -> fp32 tensors computed with the passes' loads, splits (fp32 into
    bf16 terms in shared memory), descriptors and products, each
    accumulator register written at the row and column the passes assume
    it holds: ``s`` = B Cᵀ and ``dw`` = X gyᵀ (the column pass's Sᵀ and
    dWᵀ, gy in three terms), ``dx`` = Wt gy (Wt in two terms as register A
    operands, the products hi·hi, hi·mid, lo·hi) and ``db`` = Dt C (Dt in
    two terms), ``gb`` = B gstᵀ (three terms), ``xg`` = X gst (two terms),
    ``u`` (64,) the row sums of X ⊙ gb, and ``dwr`` = gy Xᵀ (gy's first two
    terms: the row pass's dW).  Not counted in ``ssd_intra_chunk_bwd``'s
    launches."""
    dev = B.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_bwd_wgmma_layout_probe runs on a CUDA tensor, got {dev}")
    n, p = B.shape[-1], X.shape[-1]
    for name, t, shape, dtype in (("B", B, (64, n), torch.bfloat16),
                                  ("C", C, (64, n), torch.bfloat16),
                                  ("X", X, (64, p), torch.bfloat16),
                                  ("gy", gy, (64, p), torch.float32),
                                  ("gst", gst, (p, n), torch.float32),
                                  ("Wt", Wt, (64, 64), torch.float32),
                                  ("Dt", Dt, (64, 64), torch.float32)):
        _build.check_tensor(name, t, shape, (dtype,), dev)
    check_bf16_bwd_domain(X, gy, B, C, gy, gst, 64)  # the probe has no dt
    f32 = dict(dtype=torch.float32, device=dev)
    out = {"s": torch.empty((64, 64), **f32), "dw": torch.empty((64, 64), **f32),
           "dx": torch.empty((64, p), **f32), "db": torch.empty((64, n), **f32),
           "gb": torch.empty((64, p), **f32), "xg": torch.empty((64, n), **f32),
           "u": torch.empty((64,), **f32), "dwr": torch.empty((64, 64), **f32)}
    err = _build.library().ssd_bwd_probe_launch(
        B.data_ptr(), C.data_ptr(), X.data_ptr(), gy.data_ptr(), gst.data_ptr(), Wt.data_ptr(),
        Dt.data_ptr(), *(t.data_ptr() for t in out.values()), p, n,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(err, "ssd_bwd_probe_kernel")
    return out
