"""Mamba2 (SSD — state-space duality) blocks: the chunked scan for prefill
through the SSD intra-chunk kernel, and an O(1)-state recurrent step for
decode (the port's copy of ``repro.models.ssm``).

SSD recurrence (per head h, headdim p, state n):
    H_t = exp(dt_t · A) · H_{t-1} + dt_t · B_t ⊗ x_t        H ∈ R^{p×n}
    y_t = C_t · H_t + D · x_t

Dtypes are the reference's: dt is softplus in fp32, the SSD output and the
D skip term are fp32, the SSM state is fp32, and the cached conv state is
bf16 after a prefill even in a float32 config.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops as kops
from .common import Initializer, ParamModule, rms_norm

__all__ = [
    "ssm_dims",
    "MambaBlock",
    "mamba_block",
    "mamba_decode_step",
    "init_ssm_state",
    "ssd_chunked_ref",
]


def ssm_dims(cfg: ArchConfig) -> dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.headdim
    conv_dim = d_inner + 2 * s.ngroups * s.d_state
    return dict(d_inner=d_inner, nheads=nheads, conv_dim=conv_dim,
                proj_out=2 * d_inner + 2 * s.ngroups * s.d_state + nheads)


class MambaBlock(ParamModule):
    """One Mamba2 layer's weights, in the reference's layouts
    (``in_proj`` (d, proj_out), ``conv_w`` (width, conv_dim), ...)."""

    @classmethod
    def init(cls, ini: Initializer, cfg: ArchConfig) -> "MambaBlock":
        s = cfg.ssm
        dm = ssm_dims(cfg)
        d = cfg.d_model
        return cls(
            in_proj=ini.normal((d, dm["proj_out"])),
            conv_w=ini.normal((s.conv_width, dm["conv_dim"]), stddev=0.2),
            conv_b=ini.zeros((dm["conv_dim"],)),
            A_log=ini.zeros((dm["nheads"],)),  # A = -exp(A_log)
            D=ini.ones((dm["nheads"],)),
            dt_bias=ini.zeros((dm["nheads"],)),
            norm=ini.ones((dm["d_inner"],)),
            out_proj=ini.normal((dm["d_inner"], d)),
            ln=ini.ones((d,)),
        )


# ------------------------------------------------------------------------------
# Chunked SSD in PyTorch ops (the reference's jnp path, for the tests)
# ------------------------------------------------------------------------------

def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, chunk: int, init_state: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in PyTorch ops.  x (b, s, h, p), dt (b, s, h), A (h,),
    B/C (b, s, h, n) -> (y (b, s, h, p) fp32, final state (b, h, p, n) fp32)."""
    b, s_orig, h, p = x.shape
    n = B.shape[3]
    pad = (-s_orig) % chunk
    if pad:  # dt = 0 on padding: identity state transition, zero contribution
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    s = x.shape[1]
    nc = s // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    cs = torch.cumsum(dtf * A.float(), dim=2)
    seg_end = cs[:, :, -1, :]
    Bh = B.float().reshape(b, nc, chunk, h, n)
    Ch = C.float().reshape(b, nc, chunk, h, n)
    scores = torch.einsum("bzihn,bzjhn->bzhij", Ch, Bh)
    cs_h = cs.permute(0, 1, 3, 2)
    decay = cs_h[..., :, None] - cs_h[..., None, :]
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    L = torch.where(causal, torch.exp(decay), 0.0)
    y_intra = torch.einsum("bzhij,bzjh,bzjhp->bzihp", scores * L, dtf, xf)
    w = torch.exp(seg_end[:, :, None, :] - cs)
    states = torch.einsum("bzjhn,bzjh,bzjhp->bzhpn", Bh, w * dtf, xf)
    H = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    H_ins = []
    for z in range(nc):
        H_ins.append(H)
        H = H * torch.exp(seg_end[:, z])[:, :, None, None] + states[:, z]
    H_ins = torch.stack(H_ins, dim=1)
    y_inter = torch.einsum("bzihn,bzhpn,bzih->bzihp", Ch, H_ins, torch.exp(cs))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y[:, :s_orig], H


# ------------------------------------------------------------------------------
# Block wrappers
# ------------------------------------------------------------------------------

def _split_proj(z: torch.Tensor, cfg: ArchConfig):
    s = cfg.ssm
    d_in = ssm_dims(cfg)["d_inner"]
    gn = s.ngroups * s.d_state
    return z[..., :d_in], z[..., d_in: 2 * d_in + 2 * gn], z[..., 2 * d_in + 2 * gn:]


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv via shifted adds.  Returns (silu(y), new_state);
    state (b, width-1, conv_dim) holds the previous segment's trailing inputs.
    The concatenation takes the promoted dtype of state and input, as jnp's
    does."""
    width = w.shape[0]
    b, s, c = xBC.shape
    if state is None:
        state = torch.zeros((b, width - 1, c), dtype=xBC.dtype, device=xBC.device)
    dt = torch.promote_types(state.dtype, xBC.dtype)
    xp = torch.cat([state.to(dt), xBC.to(dt)], dim=1)
    y = sum(xp[:, i: i + s, :] * w[i] for i in range(width)) + bias
    return F.silu(y), xp[:, -(width - 1):, :]


def mamba_block(p, x: torch.Tensor, cfg: ArchConfig,
                init_state: torch.Tensor | None = None,
                conv_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Mamba2 layer on a full sequence.  Returns (x_out, ssm_state,
    conv_state).  The SSD scan goes through ``ops.ssd_scan``: on a CUDA
    tensor it launches ``ssd_intra_chunk_kernel`` and, where a gradient is
    taken, its backward (``ssd_scan.ssd_intra_chunk_bwd``: the tensor-core
    passes in bf16, ``ssd_intra_chunk_bwd_kernel`` in fp32; the layer
    trains on the card and on the CPU alike)."""
    s = cfg.ssm
    dm = ssm_dims(cfg)
    h = rms_norm(x, p["ln"])
    z = torch.einsum("bsd,de->bse", h, p["in_proj"])
    zgate, xBC, dt_raw = _split_proj(z, cfg)
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    d_in, gn = dm["d_inner"], s.ngroups * s.d_state
    rep = dm["nheads"] // s.ngroups
    bsz, seq = xBC.shape[:2]
    xin = xBC[..., :d_in]
    B = xBC[..., d_in: d_in + gn].reshape(bsz, seq, s.ngroups, s.d_state)
    C = xBC[..., d_in + gn:].reshape(bsz, seq, s.ngroups, s.d_state)
    B = B.repeat_interleave(rep, dim=2)
    C = C.repeat_interleave(rep, dim=2)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(bsz, seq, dm["nheads"], s.headdim)
    y, final_state = kops.ssd_scan(xh, dt, A, B, C, chunk=s.chunk, init_state=init_state)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(bsz, seq, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(zgate), p["norm"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return x + out, final_state, new_conv


def init_ssm_state(cfg: ArchConfig, n_layers: int, batch: int, device=None) -> dict:
    s = cfg.ssm
    dm = ssm_dims(cfg)
    return {
        "ssm": torch.zeros((n_layers, batch, dm["nheads"], s.headdim, s.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, s.conv_width - 1, dm["conv_dim"]),
                            dtype=torch.bfloat16, device=device),
    }


def mamba_decode_step(p, x: torch.Tensor, ssm_state: torch.Tensor,
                      conv_state: torch.Tensor, cfg: ArchConfig
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token recurrent step.  x (b, 1, d), ssm_state (b, h, p, n).
    PyTorch ops: one token is a few small products, outside any kernel."""
    s = cfg.ssm
    dm = ssm_dims(cfg)
    h = rms_norm(x, p["ln"])
    z = torch.einsum("bsd,de->bse", h, p["in_proj"])
    zgate, xBC, dt_raw = _split_proj(z, cfg)
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    d_in, gn = dm["d_inner"], s.ngroups * s.d_state
    bsz = x.shape[0]
    xin = xBC[:, 0, :d_in]
    B = xBC[:, 0, d_in: d_in + gn].reshape(bsz, s.ngroups, s.d_state)
    C = xBC[:, 0, d_in + gn:].reshape(bsz, s.ngroups, s.d_state)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())  # (b, h)
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(bsz, dm["nheads"], s.headdim).float()
    rep = dm["nheads"] // s.ngroups
    Bh = B.repeat_interleave(rep, dim=1).float()
    Ch = C.repeat_interleave(rep, dim=1).float()
    decay = torch.exp(dt * A)
    new_state = ssm_state * decay[..., None, None] + torch.einsum(
        "bh,bhn,bhp->bhpn", dt, Bh, xh)
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_state)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(zgate), p["norm"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return x + out, new_state, new_conv
