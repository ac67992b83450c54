"""Mixture-of-Experts FFN with capacity-based token dispatch: the port's copy
of ``repro.models.moe``, the shared expert included.

One body, ``_moe_shard``, runs a rank's tokens; with no process groups it
is the whole function on one device.  On a mesh (``moe_ffn`` with a
``Shards``) it runs each rank's local tokens, at the local token
count's capacity, between the reference's collectives, each an autograd
function over a mesh axis's process group (``sharding``):

  * ``ep`` (kimi-k2: experts split over 'model'): the (E, C, d) buffer
    exchanged by an all-to-all over 'model' so each rank runs its
    E/model experts on every rank's tokens, and a second all-to-all back
    (``_ep_send``, ``_ep_return``).
  * ``tp`` (grok-1: fewer experts than the model axis): every rank holds a
    d_ff slice of every expert; the expert outputs' partial sums meet in a
    psum over 'model' (identity backward), and the buffer enters the
    experts through the psum's mirror (identity forward, all-reduce
    backward), as Megatron's f and g.
  * the aux loss is averaged over ``mean_groups``, the mesh axes across
    which the tokens differ (the reference's pmean over every axis: the
    other axes hold equal copies).

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
from .sharding import NO_MESH, AllToAll, Shards, fanout, gather, group_size, pmean, psum, split

__all__ = ["init_moe_ffn", "moe_logical_axes", "moe_ffn"]


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


def moe_logical_axes(cfg: ArchConfig) -> dict:
    """Logical dim names of an MoE layer's weights, stacked (the leading
    layer dim None), as the reference's."""
    m = cfg.moe
    if m.mode == "ep":
        w = {
            "w1": (None, "w_expert", "w_exp_in", "w_exp_fe"),
            "w3": (None, "w_expert", "w_exp_in", "w_exp_fe"),
            "w2": (None, "w_expert", "w_exp_fe", "w_exp_in"),
        }
    else:  # tp
        w = {
            "w1": (None, None, "w_embed", "w_ff"),
            "w3": (None, None, "w_embed", "w_ff"),
            "w2": (None, None, "w_ff", "w_embed"),
        }
    axes = {"router": (None, None, None), **w}
    if m.n_shared_experts:
        axes["shared"] = {
            "w1": (None, "w_embed", "w_ff"),
            "w3": (None, "w_embed", "w_ff"),
            "w2": (None, "w_ff", "w_embed"),
        }
    return axes


def _ep_send(buf: torch.Tensor, group) -> torch.Tensor:
    """(E, C, d) -> (E/n, n*C, d): this rank's experts, every rank's slots
    for them in rank order (the reference's tiled all_to_all, split 0,
    concat 1)."""
    n = group_size(group)
    if n == 1:
        return buf
    E, C, d = buf.shape
    out = AllToAll.apply(buf, group)
    return out.view(n, E // n, C, d).transpose(0, 1).reshape(E // n, n * C, d)


def _ep_return(out: torch.Tensor, group) -> torch.Tensor:
    """(E/n, n*C, d) -> (E, C, d): ``_ep_send``'s inverse."""
    n = group_size(group)
    if n == 1:
        return out
    el, nc, d = out.shape
    o = out.view(el, n, nc // n, d).transpose(0, 1).reshape(n * el, nc // n, d)
    return AllToAll.apply(o, group)


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


def _moe_shard(x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
               w2: torch.Tensor, m: MoECfg, model_group=None, mean_groups: tuple = ()
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed experts on one rank's tokens: x (bl, s, d) -> (y, aux).
    With no groups this is the whole function on one device.  Weights,
    their d dim whole (``transformer.local_params`` gathers it): ep
    (E_loc, d, fe) and (E_loc, fe, d); tp (E, d, fe_loc) and (E, fe_loc, d)."""
    bl, s, d = x.shape
    t = bl * s
    E, k = m.n_experts, m.top_k
    xf = x.reshape(t, d)
    gates, gate_k, eids = _route(xf, router, m)
    # Switch aux loss: E * sum_e (fraction of assignments to e) * (mean gate of e)
    counts = torch.bincount(eids.reshape(-1), minlength=E).float()
    aux = E * torch.sum(counts / t / k * gates.mean(dim=0))
    aux = pmean(aux, mean_groups)
    buf, e_flat, pos, keep = _dispatch(xf, eids, _capacity(t, m), E)
    if m.mode == "ep":
        out = _ep_return(_experts(_ep_send(buf, model_group), w1, w3, w2), model_group)
    else:  # tp: every expert's fe slice here; one psum combines the partial d
        out = psum(_experts(fanout(buf, model_group), w1, w3, w2), model_group)
    y = _combine(out, e_flat, pos, keep, gate_k)
    return y.reshape(bl, s, d).to(x.dtype), aux


def moe_ffn(p, x: torch.Tensor, cfg: ArchConfig, sh: Shards = NO_MESH
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN for one layer: x (b, s, d) -> (y (b, s, d), the router's aux
    loss, a 0-d fp32 tensor).  On a mesh (``sh``, this rank's local
    tokens and weights) the routed experts are the reference's sharded
    ones: ep splits the sequence over the model axis when it divides
    (each rank dispatches its own tokens, the experts exchanged by
    all-to-all); tp keeps the tokens whole and psums the fe-split experts'
    outputs.  Without a mesh every group is None and this is the function
    on one device."""
    m = cfg.moe
    ms = sh.model_size
    if m.mode == "ep":
        if p["w1"].shape[0] * ms != m.n_experts:
            raise ValueError(f"{m.n_experts} experts do not split over a {ms}-way "
                             f"{sh.model_axis!r} axis")
        seq_split = ms > 1 and x.shape[1] % ms == 0
        if not seq_split and ms > 1 and torch.is_grad_enabled() and x.requires_grad:
            raise ValueError(f"MoE gradients on a mesh need the sequence ({x.shape[1]}) "
                             f"split over the {ms}-way model axis")
        xs = split(x, 1, sh.model) if seq_split else x
        means = sh.batch_groups + ((sh.model,) if seq_split else ())
        y, aux = _moe_shard(xs, p["router"], p["w1"], p["w3"], p["w2"], m,
                            model_group=sh.model, mean_groups=means)
        if seq_split:
            y = gather(y, 1, sh.model, partial=False)
    else:
        fe_split = ms > 1 and p["w1"].shape[2] < m.d_ff_expert
        y, aux = _moe_shard(x, p["router"], p["w1"], p["w3"], p["w2"], m,
                            model_group=sh.model if fe_split else None,
                            mean_groups=sh.batch_groups)
    if m.n_shared_experts:
        shared = p["shared"]
        ff_split = ms > 1 and shared["w1"].shape[1] < m.d_ff_expert * m.n_shared_experts
        y = y + swiglu(x, shared["w1"], shared["w3"], shared["w2"],
                       sh.model if ff_split else None)
    return y, aux
