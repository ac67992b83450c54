"""Mixture-of-Experts FFN with capacity-based token dispatch: the port's copy
of ``repro.models.moe`` on one device (the reference's ``_moe_shard`` with no
mesh axes, plus the shared expert).  The ``ep``/``tp`` sharding modes and
their all_to_all and psum collectives wait for the port's sharding
(ROADMAP, Queue 1, item 13); on one device both modes compute the same
function, which is what runs here.

Routing is fp32: softmax over the experts, the top k gates with the lower
expert index winning a tie (as ``lax.top_k``), renormalised; the Switch aux
loss is returned beside the output.  Dispatch ranks each (token, choice)
assignment within its expert by a stable argsort and a segment rank, and
writes the kept ones into an (E, C, d) buffer: each kept (expert, slot)
pair is unique, so a plain ``index_put_`` (no accumulate, no atomics)
writes what the reference's scatter-add of masked rows does; dropped
assignments go to one spare row past the buffer.  The three expert products
are batched GEMMs over (E, C, .), library calls as the reference leaves
them to XLA.  The combine sums each token's k weighted expert rows in a
fixed order (choice 0 first) in the activations' dtype, as the reference's
scatter-add into a zero buffer of that dtype does; no scatter-add, whose
CUDA atomics would sum in a different order from run to run.

Capacity C is fixed per call, so at decode (a few tokens) C is the
configured minimum and every expert's weights are read at each step, as in
the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, MoECfg
from .common import Initializer, swiglu

__all__ = ["init_moe_ffn", "moe_ffn"]


def init_moe_ffn(ini: Initializer, cfg: ArchConfig) -> dict:
    """One layer's MoE weights, in the reference's layouts and std rules:
    ``router`` (d, E), ``w1``/``w3`` (E, d, fe), ``w2`` (E, fe, d) and, with
    shared experts, ``shared`` {w1, w3 (d, fe * n_shared), w2}.  The expert
    stacks are drawn one expert at a time (``Initializer.normal_stack``)."""
    m = cfg.moe
    d, fe, E = cfg.d_model, m.d_ff_expert, m.n_experts
    p = {
        "router": ini.normal((d, E), stddev=0.02),
        "w1": ini.normal_stack((E, d, fe)),
        "w3": ini.normal_stack((E, d, fe)),
        "w2": ini.normal_stack((E, fe, d)),
    }
    if m.n_shared_experts:
        fs = fe * m.n_shared_experts
        p["shared"] = {"w1": ini.normal((d, fs)), "w3": ini.normal((d, fs)),
                       "w2": ini.normal((fs, d))}
    return p


def _capacity(t_loc: int, m: MoECfg) -> int:
    c = int(t_loc * m.top_k * m.capacity_factor / m.n_experts)
    c = max(c, m.min_capacity)
    return (c + 3) // 4 * 4


def _positions_in_expert(e_flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Rank of each assignment within its expert, in arrival order: a stable
    argsort groups the assignments by expert and a cumulative max over the
    segment starts recovers each one's rank in its segment."""
    a = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    idx = torch.arange(a, device=e_flat.device)
    is_start = torch.ones(a, dtype=torch.bool, device=e_flat.device)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    pos = torch.empty_like(idx)
    pos[order] = idx - seg_start
    return pos


def _top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest gates of each row, largest first, the lower index first
    among equal gates (``lax.top_k``'s order; ``torch.topk`` leaves ties
    unspecified)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _route(xf: torch.Tensor, router: torch.Tensor, m: MoECfg):
    """fp32 routing of t tokens: (gates (t, E), renormalised top-k gates
    (t, k), expert ids (t, k))."""
    logits = xf.float() @ router.float()
    gates = torch.softmax(logits, dim=-1)
    gate_k, eids = _top_k(gates, m.top_k)
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)
    return gates, gate_k, eids


def _dispatch(xf: torch.Tensor, eids: torch.Tensor, C: int, n_experts: int):
    """Each token's k assignments into an (E, C, d) buffer: (buffer, the
    flat expert ids (t*k,), their slots, kept or not)."""
    t, d = xf.shape
    k = eids.shape[1]
    e_flat = eids.reshape(-1)
    pos = _positions_in_expert(e_flat, n_experts)
    keep = pos < C
    slot = torch.where(keep, e_flat * C + pos, n_experts * C)  # dropped: the spare row
    buf = torch.zeros((n_experts * C + 1, d), dtype=xf.dtype, device=xf.device)
    buf[slot] = xf[torch.arange(t, device=xf.device).repeat_interleave(k)]
    return buf[:n_experts * C].view(n_experts, C, d), e_flat, pos, keep


def _experts(buf: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
             w2: torch.Tensor) -> torch.Tensor:
    """The three expert products, batched over E: (E, C, d) -> (E, C, d)."""
    return torch.bmm(torch.bmm(buf, w1) * F.silu(torch.bmm(buf, w3)), w2)


def _combine(out: torch.Tensor, e_flat: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
             gate_k: torch.Tensor) -> torch.Tensor:
    """Each token's k expert rows weighted by their gates (0 where dropped),
    summed choice by choice in the activations' dtype: (t, d)."""
    E, C, d = out.shape
    t, k = gate_k.shape
    wgt = gate_k.reshape(-1, 1).to(out.dtype) * keep[:, None].to(out.dtype)
    rows = (out.view(E * C, d)[e_flat * C + pos.clamp(max=C - 1)] * wgt).view(t, k, d)
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    return y


def _moe_experts(x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                 w2: torch.Tensor, m: MoECfg) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed experts on one device: x (b, s, d) -> (y (b, s, d), aux)."""
    b, s, d = x.shape
    t = b * s
    E, k = m.n_experts, m.top_k
    xf = x.reshape(t, d)
    gates, gate_k, eids = _route(xf, router, m)
    # Switch aux loss: E * sum_e (fraction of assignments to e) * (mean gate of e)
    counts = torch.bincount(eids.reshape(-1), minlength=E).float()
    aux = E * torch.sum(counts / t / k * gates.mean(dim=0))
    buf, e_flat, pos, keep = _dispatch(xf, eids, _capacity(t, m), E)
    y = _combine(_experts(buf, w1, w3, w2), e_flat, pos, keep, gate_k)
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_ffn(p, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN for one layer: x (b, s, d) -> (y (b, s, d), the router's aux
    loss, a 0-d fp32 tensor)."""
    m = cfg.moe
    y, aux = _moe_experts(x, p["router"], p["w1"], p["w3"], p["w2"], m)
    if m.n_shared_experts:
        sh = p["shared"]
        y = y + swiglu(x, sh["w1"], sh["w3"], sh["w2"])
    return y, aux
