"""Decoder-only transformer (GQA, RoPE/M-RoPE, qk-norm, SwiGLU or MoE FFN):
the port's copy of ``repro.models.transformer``, serving path.

Covers the dense family (qwen3-32b, minitron-8b, phi3-medium-14b,
codeqwen1.5-7b), the moe family (grok-1-314b, kimi-k2-1t-a32b: the FFN is
``moe.moe_ffn``), the qwen2-vl-2b backbone (patch embeddings enter before
the text as precomputed vectors, M-RoPE position streams as inputs), and
the attention block the hybrid and enc-dec families share.  The reference
stacks the layers (a leading L dim) and applies them with ``lax.scan``;
here each layer is a ``DenseBlock`` in the ``blocks`` ModuleList of a
``DenseLM`` and a Python loop applies them.  Training: ``dense_loss`` over
``dense_train_logits`` (logits at every position, the MoE router's aux
loss summed over the layers), each layer under the config's ``remat``
policy.

One path runs on one device and on a mesh.  Every function takes ``sh``,
a ``sharding.Shards``: ``NO_MESH`` by default, where every group is None
and every collective returns its input, so the single-device operations
run in their order (on a (1, 1, 1) mesh too, bit for bit).  On a mesh
each rank runs the model on its local shards (``local_params``: the
DTensor weights' local tensors, gathered over their FSDP dims, "w_embed"
-> data, by an all-gather whose backward reduce-scatters) with explicit
collectives, as the reference's model runs under ``jit`` with sharding
constraints (and its MoE under ``shard_map``).  The batch splits over
("pod", "data"); the tensor-parallel splits ("heads", "ff", "vocab" ->
model) are Megatron's; the activations between blocks are replicated over
the model axis ("seq_sp" off, as the default rules have it).  Each of the
reference's ``rules.shard`` points is a collective here, or nothing where
the layout does not change:

  * ``_embed``: a vocab-split table: each rank looks up its rows, a psum
    joins them ("batch", "seq_sp", "embed");
  * ``attn_block``: the input enters the heads split through ``fanout``
    (identity; all-reduce of its gradient), q takes this rank's heads
    ("heads"), k and v all kv heads, of which the kernel gets those its
    heads read (``attention.local_kv_heads``); the output projection's
    partial sums meet in a psum ("seq_sp", "embed");
  * ``_ffn``: ``common.swiglu`` around the ff split ("ff"), or
    ``moe.moe_ffn`` with the reference's collectives;
  * ``dense_loss``: vocab-split logits ("vocab"): ``cross_entropy_loss``
    reduces over the shards, and the mean over the batch shards;
  * decode: the KV cache split over its slots ("kv_seq" -> model);
    ``decode_attention`` reduces its softmax over the shards.

Gradients (``_grad_placements``): a weight split over a mesh dim gets its
exact shard's gradient there (the FSDP gather's reduce-scatter, or the
tensor-parallel split); a weight replicated over a dim across which the
tokens differ (the batch axes) gets a partial sum, which the optimizer
reduces; over the model axis a replicated weight's gradient is the same on
every rank, except for those used inside the heads split (wk, wv, q_norm,
k_norm: each rank's heads contribute) and the ep router (each rank routes
its own tokens), which are partial sums.

Weights keep the reference's layouts: ``wq`` (d, h, hd), ``wk``/``wv``
(d, kv, hd), ``wo`` (h, hd, d), so the einsums read the same.  Head
padding is the reference's: Q heads pad to a multiple of 16 and KV heads
to a divisor of the padded Q heads (phi3: 40 -> 48 Q, 10 -> 12 KV).
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from .attention import attention, decode_attention, local_kv_heads
from .common import (DTYPES, Initializer, ParamModule, apply_rope, cross_entropy_loss, remat,
                     rms_norm, swiglu)
from .moe import init_moe_ffn, moe_ffn, moe_logical_axes
from .sharding import NO_MESH, Shards, fanout, gather, pmean, psum

__all__ = [
    "TP_MULTIPLE",
    "MROPE_SECTIONS",
    "padded_dims",
    "param_logical_axes",
    "cache_logical_axes",
    "attn_block",
    "attn_block_decode",
    "DenseBlock",
    "DenseLM",
    "init_dense",
    "dense_layer",
    "dense_layer_decode",
    "dense_init_cache",
    "dense_prefill",
    "dense_decode_step",
    "dense_train_logits",
    "dense_loss",
    "local_params",
]

TP_MULTIPLE = 16  # the reference pads heads for its production model axis

MROPE_SECTIONS = (16, 24, 24)  # qwen2-vl half-dim split (t, h, w)


def padded_dims(cfg: ArchConfig) -> tuple[int, int, int]:
    """(padded_q_heads, padded_kv_heads, padded_vocab), as the reference
    pads them (padded heads have zero output rows at init)."""
    hp = cfg.heads_padded(TP_MULTIPLE)
    kv = cfg.n_kv_heads
    while hp % kv:
        kv += 1
    return hp, kv, cfg.vocab_padded(TP_MULTIPLE)


def param_logical_axes(cfg: ArchConfig) -> dict:
    """Logical dim names per parameter, in the reference's stacked tree (the
    layer dim first, None); a port layer's tensor takes its leaf's names
    without the leading None."""
    attn = {
        "wq": (None, "w_embed", "w_heads", None),
        "wk": (None, "w_embed", "w_kv_heads", None),
        "wv": (None, "w_embed", "w_kv_heads", None),
        "wo": (None, "w_heads", None, "w_embed"),
    }
    if cfg.qk_norm:
        attn["q_norm"] = (None, None)
        attn["k_norm"] = (None, None)
    blocks: dict = {"attn": attn, "ln1": (None, None), "ln2": (None, None)}
    if cfg.moe is not None:
        blocks["moe"] = moe_logical_axes(cfg)
    else:
        blocks["mlp"] = {
            "w1": (None, "w_embed", "w_ff"),
            "w3": (None, "w_embed", "w_ff"),
            "w2": (None, "w_ff", "w_embed"),
        }
    return {
        "embed": ("w_vocab", "w_embed"),
        "blocks": blocks,
        "final_norm": (None,),
        "head": ("w_embed", "w_vocab"),
    }


def cache_logical_axes() -> dict:
    return {
        "k": (None, "batch", "kv_heads", "kv_seq", None),
        "v": (None, "batch", "kv_heads", "kv_seq", None),
        "index": (),
    }


def _attn_params(ini: Initializer, d: int, hp: int, kvp: int, hd: int, qk_norm: bool) -> dict:
    """One attention block's weights, drawn with the reference's std rules
    (a stacked (1, ...) draw has the same fan-in as this unstacked one)."""
    p = {
        "wq": ini.normal((d, hp, hd)),
        "wk": ini.normal((d, kvp, hd)),
        "wv": ini.normal((d, kvp, hd)),
        "wo": ini.normal((hp, hd, d), stddev=1.0 / (hp * hd) ** 0.5),
    }
    if qk_norm:
        p["q_norm"] = ini.ones((hd,))
        p["k_norm"] = ini.ones((hd,))
    return p


def _mlp_params(ini: Initializer, d: int, f: int) -> dict:
    return {"w1": ini.normal((d, f)), "w3": ini.normal((d, f)), "w2": ini.normal((f, d))}


def _qkv(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    sections = MROPE_SECTIONS if cfg.mrope else None
    q = apply_rope(q, positions, cfg.rope_theta, sections)
    k = apply_rope(k, positions, cfg.rope_theta, sections)
    return q, k, v


def _heads_split(p, cfg: ArchConfig, sh: Shards) -> bool:
    """Whether ``p``'s query heads are this rank's share of the padded heads."""
    return sh.model_size > 1 and p["wq"].shape[1] < padded_dims(cfg)[0]


def _vocab_group(width: int, cfg: ArchConfig, sh: Shards):
    """The model axis's group where a table of ``width`` vocabulary rows
    or columns is this rank's slice, else None."""
    return sh.model if sh.model_size > 1 and width < padded_dims(cfg)[2] else None


def attn_block(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
               causal: bool = True, sh: Shards = NO_MESH
               ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (prefill).  Returns (out, (k, v)), k and v in
    (b, s, kv, hd) over every kv head (what the cache holds); on a mesh the
    kernel runs this rank's query heads and the kv heads they read."""
    split_ = _heads_split(p, cfg, sh)
    q, k, v = _qkv(p, fanout(x, sh.model) if split_ else x, positions, cfg)
    kl, vl = k, v
    if split_:
        hp, kvp, _ = padded_dims(cfg)
        kl, vl = local_kv_heads(k, v, sh.model_rank, q.shape[2], hp // kvp)
    o = attention(q, kl, vl, causal=causal)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return (psum(out, sh.model) if split_ else out), (k, v)


def attn_block_decode(p, x: torch.Tensor, position: torch.Tensor, idx: int,
                      k_cache: torch.Tensor, v_cache: torch.Tensor, cfg: ArchConfig,
                      sh: Shards = NO_MESH, slot0: int = 0, slots_split: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention.  Writes the token's k and v into slot ``idx`` of
    the (b, kv, S, hd) caches in place (the reference returns updated
    copies) and returns (out, k_cache, v_cache).  On a mesh whose model
    axis splits the slots (``slots_split``) the caches are this rank's
    slots from ``slot0``; the query heads are gathered, and each rank
    keeps its heads' output."""
    q, k, v = _qkv(p, x, position, cfg)
    n = k_cache.shape[2]
    if not slots_split or slot0 <= idx < slot0 + n:
        k_cache[:, :, idx - slot0] = k[:, 0]
        v_cache[:, :, idx - slot0] = v[:, 0]
    split_ = _heads_split(p, cfg, sh)
    q_all = gather(q, 2, sh.model, partial=False) if split_ else q
    length_mask = (torch.arange(slot0, slot0 + n, device=x.device) <= idx)[None, :].expand(
        x.shape[0], n)
    o = decode_attention(q_all, k_cache, v_cache, length_mask,
                         sh.model if slots_split else None)
    if split_:
        h_loc = q.shape[2]
        o = o[:, :, sh.model_rank * h_loc:(sh.model_rank + 1) * h_loc]
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return (psum(out, sh.model) if split_ else out), k_cache, v_cache


# ------------------------------------------------------------------------------
# The dense model
# ------------------------------------------------------------------------------

class DenseBlock(ParamModule):
    """One attention + FFN layer: ``attn`` (wq, wk, wv, wo, and q_norm,
    k_norm under qk-norm), ``ln1``, ``ln2`` and either ``mlp`` (w1, w3, w2)
    or, for a config with ``moe``, ``moe`` (router, w1, w3, w2 and perhaps
    ``shared``).  The hybrid family's shared block is one too."""

    @classmethod
    def init(cls, ini: Initializer, cfg: ArchConfig) -> "DenseBlock":
        hp, kvp, _ = padded_dims(cfg)
        d = cfg.d_model
        attn = _attn_params(ini, d, hp, kvp, cfg.resolved_head_dim, cfg.qk_norm)
        if cfg.moe is not None:
            ffn = {"moe": init_moe_ffn(ini, cfg)}
        else:
            ffn = {"mlp": _mlp_params(ini, d, cfg.d_ff)}
        return cls(attn=attn, **ffn, ln1=ini.ones((d,)), ln2=ini.ones((d,)))


class DenseLM(ParamModule):
    """The dense model's weights: ``embed`` (vocab_padded, d), ``blocks`` (a
    ModuleList of the n_layers layers), ``final_norm`` and ``head``
    (d, vocab_padded).  Its state dict names follow the reference's tree
    with the layer axis unstacked (``blocks.<i>.attn.wq``)."""

    def __init__(self, embed, blocks: list, final_norm, head):
        super().__init__(embed=embed, final_norm=final_norm, head=head)
        self.blocks = nn.ModuleList(blocks)


def init_dense(cfg: ArchConfig, seed: int, device) -> DenseLM:
    """Weights drawn layer by layer, and an MoE layer's experts one expert
    at a time (the reference draws each stacked (L, ...) tensor at once,
    which at qwen3-32b would need a 33.6 GB float32 temporary for w1)."""
    _, _, vp = padded_dims(cfg)
    d = cfg.d_model
    ini = Initializer(seed, DTYPES[cfg.dtype], device)
    embed = ini.normal((vp, d), stddev=1.0)
    blocks = [DenseBlock.init(ini, cfg) for _ in range(cfg.n_layers)]
    return DenseLM(embed, blocks, ini.ones((d,)), ini.normal((d, vp)))


def _ffn(p, x: torch.Tensor, cfg: ArchConfig, sh: Shards = NO_MESH
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The dense SwiGLU (over this rank's slice of the ``ff`` hidden units
    on a mesh) or the MoE FFN: (y, the router's aux loss, or None for a
    dense FFN).  Serving drops the aux; training sums it."""
    if cfg.moe is not None:
        return moe_ffn(p["moe"], x, cfg, sh)
    mlp = p["mlp"]
    split_ = sh.model_size > 1 and mlp["w1"].shape[1] < cfg.d_ff
    return swiglu(x, mlp["w1"], mlp["w3"], mlp["w2"], sh.model if split_ else None), None


def _positions_for(b: int, seq: int, device, mrope: bool = False) -> torch.Tensor:
    """Positions 0..seq-1 for every lane: (b, seq), or (3, b, seq) with the
    three M-RoPE streams equal (text only)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None].expand(b, seq)
    return pos[None].expand(3, b, seq) if mrope else pos


def _embed(table: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig,
           sh: Shards = NO_MESH) -> torch.Tensor:
    """Token embeddings; from a vocab-split table each rank looks up its
    own rows, zeros elsewhere, joined by a psum."""
    group = _vocab_group(table.shape[0], cfg, sh)
    if group is None:
        return table[tokens]
    v_loc = table.shape[0]
    local = tokens - sh.model_rank * v_loc
    hit = (local >= 0) & (local < v_loc)
    x = table[local.clamp(0, v_loc - 1)] * hit[..., None].to(table.dtype)
    return psum(x, group)


def _embed_inputs(params, tokens: torch.Tensor, cfg: ArchConfig,
                  img_embeds: torch.Tensor | None = None, sh: Shards = NO_MESH) -> torch.Tensor:
    """Token embeddings, with a vlm batch's image embeddings placed before
    the text."""
    x = _embed(params["embed"], tokens, cfg, sh)
    if cfg.family == "vlm" and img_embeds is not None:
        x = torch.cat([img_embeds.to(x.dtype), x], dim=1)
    return x


def _head(x: torch.Tensor, head: torch.Tensor, cfg: ArchConfig, sh: Shards) -> torch.Tensor:
    """The logits, this rank's vocabulary slice of them on a mesh."""
    group = _vocab_group(head.shape[1], cfg, sh)
    return torch.einsum("bsd,dv->bsv", fanout(x, group), head)


def _full_logits(x: torch.Tensor, head: torch.Tensor, cfg: ArchConfig, sh: Shards):
    """The logits over the whole padded vocabulary."""
    return gather(_head(x, head, cfg, sh), 2, _vocab_group(head.shape[1], cfg, sh),
                  partial=False)


def dense_layer(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                sh: Shards = NO_MESH) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One layer on a full sequence.  Returns (x_out, (k, v)), k and v in
    (b, s, kv, hd).  (The reference also returns the MoE router's aux loss,
    which serving does not read.)"""
    h, kv = attn_block(p["attn"], rms_norm(x, p["ln1"]), positions, cfg, sh=sh)
    x = x + h
    return x + _ffn(p, rms_norm(x, p["ln2"]), cfg, sh)[0], kv


def dense_layer_decode(p, x: torch.Tensor, position: torch.Tensor, idx: int,
                       k_cache: torch.Tensor, v_cache: torch.Tensor, cfg: ArchConfig,
                       sh: Shards = NO_MESH, slot0: int = 0, slots_split: bool = False
                       ) -> torch.Tensor:
    """One layer on one token per lane, writing its k and v into slot
    ``idx`` of the (b, kv, S, hd) caches in place."""
    h, _, _ = attn_block_decode(p["attn"], rms_norm(x, p["ln1"]), position, idx,
                                k_cache, v_cache, cfg, sh, slot0, slots_split)
    x = x + h
    return x + _ffn(p, rms_norm(x, p["ln2"]), cfg, sh)[0]


def dense_init_cache(cfg: ArchConfig, batch: int, max_seq: int,
                     dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    _, kvp, _ = padded_dims(cfg)
    shape = (cfg.n_layers, batch, kvp, max_seq, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


def _slots(sh: Shards, max_seq: int) -> tuple[int, int]:
    """(first slot, slot count) of this rank's share of the cache's
    sequence ("kv_seq" -> model, when the model axis divides it)."""
    m = sh.model_size
    if m == 1 or max_seq % m:
        return 0, max_seq
    n = max_seq // m
    return sh.model_rank * n, n


def dense_prefill(params, tokens: torch.Tensor, cfg: ArchConfig, max_seq: int,
                  img_embeds: torch.Tensor | None = None,
                  positions: torch.Tensor | None = None, sh: Shards = NO_MESH):
    """A full forward that writes each layer's k and v straight into a
    (L, b, kv, max_seq, hd) cache in the activations' dtype (the reference
    stacks them and pads).  A vlm batch may add ``img_embeds`` (b, img, d),
    which come before the text, and ``positions`` ((3, b, img + text) for
    M-RoPE); without them the positions are 0..seq-1 on every stream.
    Returns (last-position logits (b, 1, vocab_padded), cache).  On a mesh
    the batch is this rank's rows, and where the model axis splits the
    slots the cache holds this rank's (``slot0`` its first,
    ``slots_split``)."""
    x = _embed_inputs(params, tokens, cfg, img_embeds, sh)
    b, seq = x.shape[:2]
    if seq > max_seq:
        raise ValueError(f"prompt of {seq} tokens exceeds max_seq={max_seq}")
    if positions is None:
        positions = _positions_for(b, seq, x.device, cfg.mrope)
    lo, n = _slots(sh, max_seq)
    cache = dense_init_cache(cfg, b, n, dtype=x.dtype, device=x.device)
    if n < max_seq:
        cache.update(slot0=lo, slots_split=True)
    a, e = min(lo, seq), min(lo + n, seq)
    for i, layer in enumerate(params["blocks"]):
        x, (k, v) = dense_layer(layer, x, positions, cfg, sh)
        cache["k"][i, :, :, a - lo:e - lo] = k[:, a:e].transpose(1, 2)
        cache["v"][i, :, :, a - lo:e - lo] = v[:, a:e].transpose(1, 2)
    x = rms_norm(x[:, -1:], params["final_norm"])
    cache["index"] = seq
    return _full_logits(x, params["head"], cfg, sh), cache


def dense_decode_step(params, tokens: torch.Tensor, cache: dict, cfg: ArchConfig,
                      sh: Shards = NO_MESH):
    """One token per lane.  Updates ``cache`` in place (the reference returns
    a new cache) and returns (logits (b, 1, vocab_padded), cache)."""
    idx = int(cache["index"])
    lo, slots_split = int(cache.get("slot0", 0)), bool(cache.get("slots_split", False))
    n = cache["k"].shape[3]
    total = n * sh.model_size if slots_split else n
    if idx >= total:
        raise ValueError(f"KV cache full: index {idx} of {total} slots")
    x = _embed(params["embed"], tokens, cfg, sh)
    # the cache index on every stream under M-RoPE, as the reference has it
    position = _positions_for(x.shape[0], 1, x.device, cfg.mrope) + idx
    for i, layer in enumerate(params["blocks"]):
        x = dense_layer_decode(layer, x, position, idx, cache["k"][i], cache["v"][i], cfg,
                               sh, lo, slots_split)
    x = rms_norm(x, params["final_norm"])
    cache["index"] = idx + 1
    return _full_logits(x, params["head"], cfg, sh), cache


# ------------------------------------------------------------------------------
# Training
# ------------------------------------------------------------------------------

def _attn_half(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
               sh: Shards = NO_MESH) -> torch.Tensor:
    """The residual after a layer's attention (the reference's
    ``resid_attn``)."""
    return x + attn_block(p["attn"], rms_norm(x, p["ln1"]), positions, cfg, sh=sh)[0]


def _ffn_half(p, x: torch.Tensor, cfg: ArchConfig, sh: Shards = NO_MESH
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual after a layer's FFN (``resid_mlp``) and the MoE router's
    aux loss (a 0-d fp32 zero for a dense FFN)."""
    y, aux = _ffn(p, rms_norm(x, p["ln2"]), cfg, sh)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def dense_train_layer(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                      sh: Shards = NO_MESH) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer on a full sequence under ``cfg.remat``: (x_out, aux).
    ``"full"`` and ``"dots"`` checkpoint the whole layer (``common.remat``);
    ``"names"`` keeps exactly the two residuals, as the reference's
    ``save_only_these_names("resid_attn", "resid_mlp")``: each half is a
    checkpointed segment, so a residual is kept as the next segment's
    input and everything else is recomputed."""
    if cfg.remat == "names":
        x = remat(_attn_half, "full")(p, x, positions, cfg, sh)
        return remat(_ffn_half, "full")(p, x, cfg, sh)

    def layer(p, x, positions):
        return _ffn_half(p, _attn_half(p, x, positions, cfg, sh), cfg, sh)

    return remat(layer, cfg.remat)(p, x, positions)


def dense_train_logits(params, batch: dict, cfg: ArchConfig, sh: Shards = NO_MESH
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Logits at every position (b, s, vocab_padded; this rank's vocabulary
    slice on a mesh) and the router aux summed over the layers, from a
    batch of tensors: ``tokens``, and for a vlm ``img_embeds`` (before the
    text) and ``positions`` if given."""
    x = _embed_inputs(params, batch["tokens"], cfg, batch.get("img_embeds"), sh)
    b, seq = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions_for(b, seq, x.device, cfg.mrope)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["blocks"]:
        x, a = dense_train_layer(layer, x, positions, cfg, sh)
        aux = aux + a
    x = rms_norm(x, params["final_norm"])
    return _head(x, params["head"], cfg, sh), aux


def dense_loss(params, batch: dict, cfg: ArchConfig, sh: Shards = NO_MESH
               ) -> tuple[torch.Tensor, dict]:
    """(loss, metrics): the cross-entropy of the text positions (a vlm's
    image positions are cut), plus ``router_aux_coef * aux / n_layers``
    for an MoE config (then also in the metrics as ``router_aux``).  On a
    mesh each is the mean over the whole batch, the same on every rank."""
    logits, aux = dense_train_logits(params, batch, cfg, sh)
    if cfg.family == "vlm" and "img_embeds" in batch:
        logits = logits[:, batch["img_embeds"].shape[1]:]
    loss, metrics = cross_entropy_loss(logits, batch["labels"], cfg.vocab,
                                       group=_vocab_group(params["head"].shape[1], cfg, sh))
    if sh.batch_size > 1:
        loss = pmean(loss, sh.batch_groups)
        metrics = {k: loss if k == "loss" else pmean(v, sh.batch_groups)
                   for k, v in metrics.items()}
    if cfg.moe is not None:
        aux_term = cfg.moe.router_aux_coef * aux / cfg.n_layers
        loss = loss + aux_term
        metrics = dict(metrics, loss=loss, router_aux=aux_term.detach())
    return loss, metrics


# ------------------------------------------------------------------------------
# The weights on a mesh
# ------------------------------------------------------------------------------

# weights replicated over the model axis whose use sits inside the heads
# split, so each rank's gradient of them is a partial sum
_HEAD_SPLIT_WEIGHTS = ("attn/wk", "attn/wv", "attn/q_norm", "attn/k_norm")


def _grad_placements(path: str, p, sh: Shards, cfg: ArchConfig) -> list:
    """The placements of a DTensor weight's gradient as this rank computes
    it from its local shard (the module docstring's rule)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    hp, _, _ = padded_dims(cfg)
    heads_split = sh.model_size > 1 and hp % sh.model_size == 0
    out = []
    for i, pl in enumerate(p.placements):
        if isinstance(pl, Shard):
            out.append(pl)
        elif sh.names[i] == sh.model_axis:
            partial = ((heads_split and any(path.endswith(w) for w in _HEAD_SPLIT_WEIGHTS))
                       or (path.endswith("moe/router") and cfg.moe is not None
                           and cfg.moe.mode == "ep"))
            out.append(Partial() if partial else Replicate())
        else:
            out.append(Partial() if sh.names[i] in sh.batch_axes else Replicate())
    return out


def _nest(flat: dict) -> dict:
    """Dotted names -> nested dicts, a run of digit keys as a list."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *keys, last = name.split(".")
        for key in keys:
            node = node.setdefault(key, {})
        node[last] = t

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return fix(tree)


def local_params(params, cfg: ArchConfig, sh: Shards = NO_MESH):
    """The weights this rank computes with: without a mesh, ``params``; on
    a mesh, each DTensor's local shard with its gradient's placements
    (``_grad_placements``), gathered over every split mesh dim but the
    model axis (FSDP), nested as the module is (``blocks`` a list)."""
    if sh.mesh is None:
        return params
    from torch.distributed.tensor import DTensor, Shard

    from ..convert import _split

    flat = {}
    for name, p in params.named_parameters():
        if not isinstance(p, DTensor):
            flat[name] = p
            continue
        path, _ = _split(cfg, name)
        t = p.to_local(grad_placements=_grad_placements(path, p, sh, cfg))
        for i in reversed(range(len(sh.names))):
            pl = p.placements[i]
            if isinstance(pl, Shard) and sh.names[i] != sh.model_axis:
                t = gather(t, pl.dim, sh.mesh.get_group(i), partial=True)
        flat[name] = t
    return _nest(flat)
