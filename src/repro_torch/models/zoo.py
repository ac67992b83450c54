"""Uniform model API (the port's counterpart of ``repro.models.zoo``) over
the six families (``dense``, ``moe``, ``vlm``, ``ssm``, ``hybrid``,
``encdec``):

    model = build_model(cfg, mesh=None, device=...)
    params = model.init(seed)                      -> nn.Module on the device
    model.param_axes(), model.cache_axes()         -> logical-axis trees
    cache = model.init_cache(batch, max_seq)
    logits, cache = model.prefill(params, batch, max_seq)
    logits, cache = model.decode_step(params, tokens, cache)
    loss, metrics = model.loss(params, batch)      # differentiable, for training

A batch is the reference's dict of numpy arrays or tensors: ``tokens``
(b, s); for vlm optionally ``img_embeds`` (b, img_tokens, d) and
``positions`` (3, b, img_tokens + s); for encdec ``frames``
(b, enc_seq, d), without which prefill raises ``ValueError`` (the
reference raises ``KeyError``).  A training batch adds ``labels`` (b, s).
``device=None`` is the CUDA device and raises where there is none;
``"cpu"`` runs the kernels' plain versions.  ``loss`` records autograd
(no ``inference_mode``); ``prefill`` and ``decode_step`` do not.

On a mesh (``build_model(cfg, mesh=...)``, a ``DeviceMesh`` from
``launch.mesh``) the rules come from ``make_rules(mesh,
cfg.sharding_overrides)``: ``init`` places each weight as a DTensor by
``launch.specs.param_shardings``; ``loss``, ``prefill`` and
``decode_step`` take a batch of full tensors (the same on every rank),
keep this rank's rows (``batch_logical_axes``) and run the same
``transformer`` functions as one device on the weights' local shards
(``transformer.local_params``); the device is the mesh's.  ``loss``
returns its loss and metrics as plain tensors, the same on every rank;
``prefill`` and ``decode_step`` return DTensor logits (split over the
batch) and a cache of DTensors placed as ``cache_axes`` says.  The dense,
moe and vlm families run on a mesh; ssm, hybrid and
encdec raise ``NotImplementedError`` there (their SSD kernel under
"ssm_heads" -> model needs its own local wrapper, ROADMAP Queue 1, item
21), though their axes trees are here.

The SSM family (mamba2) lives here, as in the reference: a stack of Mamba2
layers between the embedding and the head, with an O(1) decode state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..configs.base import PORTED_FAMILIES, ArchConfig
from ..device import resolve_device
from . import encdec, hybrid, ssm, transformer
from .common import DTYPES, Initializer, ParamModule, cross_entropy_loss, remat, rms_norm
from .sharding import ShardingRules, Shards, make_rules

__all__ = ["Model", "SSMLM", "batch_logical_axes", "build_model"]


_TRANSFORMER = ("dense", "moe", "vlm")

# where the families that do not run on a mesh yet are queued
MESH_ITEM = "ROADMAP Queue 1, item 21"


def batch_logical_axes(name: str, shape: tuple) -> tuple:
    """Logical dim names of a batch entry, as the reference's
    ``batch_shardings`` places it: M-RoPE positions (3, b, s) split over
    the batch on their second dim, image embeddings and frames (b, s, d),
    everything else over its first dim."""
    if name == "positions" and len(shape) == 3 and shape[0] == 3:
        return (None, "batch", "seq")
    if name in ("img_embeds", "frames"):
        return ("batch", "seq", "embed")
    return ("batch",) + (None,) * (len(shape) - 1)


def _tensor(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A batch entry (numpy array or tensor) on ``device``.  A numpy array is
    copied (it may be read-only); a bfloat16 one (``ml_dtypes``) goes
    through its bits."""
    if isinstance(x, np.ndarray):
        if x.dtype.name == "bfloat16":
            x = torch.from_numpy(np.array(x).view(np.uint16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)


def _tokens(x, device: torch.device) -> torch.Tensor:
    return _tensor(x, device, torch.int64)


# ------------------------------------------------------------------------------
# The SSM family
# ------------------------------------------------------------------------------

class SSMLM(ParamModule):
    """The SSM model's weights: ``embed`` (vocab_padded, d), ``mamba`` (a
    ModuleList of the n_layers Mamba2 layers), ``final_norm`` and ``head``
    (d, vocab_padded), named as the reference's tree with the layer axis
    unstacked (``mamba.<i>.in_proj``)."""

    def __init__(self, embed, mamba: list, final_norm, head):
        super().__init__(embed=embed, final_norm=final_norm, head=head)
        self.mamba = nn.ModuleList(mamba)


def _init_ssm(cfg: ArchConfig, seed: int, device) -> SSMLM:
    ini = Initializer(seed, DTYPES[cfg.dtype], device)
    vp = cfg.vocab_padded(transformer.TP_MULTIPLE)
    embed = ini.normal((vp, cfg.d_model), stddev=1.0)
    mamba = [ssm.MambaBlock.init(ini, cfg) for _ in range(cfg.n_layers)]
    return SSMLM(embed, mamba, ini.ones((cfg.d_model,)), ini.normal((cfg.d_model, vp)))


def _ssm_forward(params: SSMLM, tokens: torch.Tensor, cfg: ArchConfig, collect: bool = False):
    """Full-sequence forward.  Returns (x after the final norm, per-layer
    (ssm, conv) states; empty unless ``collect``)."""
    x = params["embed"][tokens]
    states = []
    for layer in params["mamba"]:
        x, st, cv = ssm.mamba_block(layer, x, cfg)
        if collect:
            states.append((st, cv))
    return rms_norm(x, params["final_norm"]), states


def _ssm_train_logits(params: SSMLM, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Logits at every position (b, s, vocab_padded), each Mamba2 layer
    checkpointed unless ``remat`` is "none", as the reference's
    ``jax.checkpoint`` of a layer: on the card a checkpointed layer
    launches the SSD forward twice (the forward and its recompute) and the
    SSD backward kernel once per step and microbatch."""
    x = params["embed"][batch["tokens"]]
    run = remat(lambda layer, x: ssm.mamba_block(layer, x, cfg)[0],
                "none" if cfg.remat == "none" else "full")
    for layer in params["mamba"]:
        x = run(layer, x)
    x = rms_norm(x, params["final_norm"])
    return torch.einsum("bsd,dv->bsv", x, params["head"])


def _ssm_loss(params: SSMLM, batch: dict, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    return cross_entropy_loss(_ssm_train_logits(params, batch, cfg), batch["labels"], cfg.vocab)


def _ssm_prefill(params: SSMLM, tokens: torch.Tensor, cfg: ArchConfig):
    """Returns (last-position logits (b, 1, vocab_padded), cache): the
    per-layer SSM states in fp32 and conv states in bf16, as the reference
    caches them."""
    x, states = _ssm_forward(params, tokens, cfg, collect=True)
    logits = torch.einsum("bsd,dv->bsv", x[:, -1:], params["head"])
    cache = {"ssm": torch.stack([st for st, _ in states]),
             "conv": torch.stack([cv for _, cv in states]).to(torch.bfloat16),
             "index": tokens.shape[1]}
    return logits, cache


def _ssm_decode(params: SSMLM, tokens: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One token per lane.  Updates ``cache`` in place; the conv state is read
    in the activations' dtype and stored back in the cache's (bf16), as the
    reference does."""
    x = params["embed"][tokens]
    for i, layer in enumerate(params["mamba"]):
        x, st, cv = ssm.mamba_decode_step(layer, x, cache["ssm"][i],
                                          cache["conv"][i].to(x.dtype), cfg)
        cache["ssm"][i] = st
        cache["conv"][i] = cv
    x = rms_norm(x, params["final_norm"])
    cache["index"] = int(cache["index"]) + 1
    return torch.einsum("bsd,dv->bsv", x, params["head"]), cache


# ------------------------------------------------------------------------------
# The uniform API
# ------------------------------------------------------------------------------

@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: torch.device
    rules: ShardingRules = dataclasses.field(default_factory=lambda: make_rules(None))

    @property
    def mesh(self):
        return self.rules.mesh

    def init(self, seed: int = 0) -> nn.Module:
        """Weights drawn from ``torch.Generator(device).manual_seed(seed)``
        with the reference's std rules (not the reference's numbers).  On a
        mesh every rank draws the same full weights and keeps its shard."""
        f = self.cfg.family
        if f in _TRANSFORMER:
            params = transformer.init_dense(self.cfg, seed, self.device)
        elif f == "ssm":
            params = _init_ssm(self.cfg, seed, self.device)
        elif f == "encdec":
            params = encdec.init_encdec(self.cfg, seed, self.device)
        else:
            params = hybrid.init_hybrid(self.cfg, seed, self.device)
        if self.mesh is not None:
            from ..launch import specs

            specs.place_params(self, params)
        return params

    def param_axes(self) -> dict:
        """Logical dim names per parameter, in the reference's tree (stacked
        leaves with a leading None)."""
        f = self.cfg.family
        if f in _TRANSFORMER:
            return transformer.param_logical_axes(self.cfg)
        if f == "ssm":
            return {
                "embed": ("w_vocab", "w_embed"),
                "mamba": ssm.mamba_logical_axes(),
                "final_norm": (None,),
                "head": ("w_embed", "w_vocab"),
            }
        if f == "hybrid":
            return hybrid.hybrid_param_axes(self.cfg)
        return encdec.encdec_param_axes(self.cfg)

    def cache_axes(self) -> dict:
        f = self.cfg.family
        if f in _TRANSFORMER:
            return transformer.cache_logical_axes()
        if f == "ssm":
            return {**ssm.ssm_state_logical_axes(), "index": ()}
        if f == "hybrid":
            return hybrid.hybrid_cache_axes()
        return encdec.encdec_cache_axes()

    @property
    def shards(self) -> Shards:
        """This rank's view of the mesh (``NO_MESH``'s without one)."""
        return Shards(self.rules)

    def _local_batch(self, sh: Shards, batch: dict) -> dict:
        """This rank's rows of a batch of full tensors (the batch itself
        without a mesh)."""
        if sh.batch_size == 1:
            return batch
        return {name: sh.local_batch(t, batch_logical_axes(name, tuple(t.shape)).index("batch"))
                for name, t in batch.items()}

    def _dtensor(self, t: torch.Tensor, names: tuple, shape: tuple):
        """A local shard as the DTensor of global ``shape`` that the names
        place."""
        from torch.distributed.tensor import DTensor

        pl = self.rules.placements(*names, dims=tuple(shape))
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(t, self.mesh, pl, run_check=False, shape=torch.Size(shape),
                                  stride=stride)

    def _logits_out(self, logits: torch.Tensor, batch: int) -> torch.Tensor:
        """On a mesh the DTensor of this rank's rows of the logits."""
        if self.mesh is None:
            return logits
        return self._dtensor(logits, ("batch", None, None), (batch, *logits.shape[1:]))

    def _cache_out(self, cache: dict, batch: int, max_seq: int) -> dict:
        """On a mesh the cache's k and v as the DTensors ``cache_axes``
        places."""
        if self.mesh is None:
            return cache
        _, kvp, _ = transformer.padded_dims(self.cfg)
        shape = (self.cfg.n_layers, batch, kvp, max_seq, self.cfg.resolved_head_dim)
        names = transformer.cache_logical_axes()["k"]
        return dict(cache, **{k: self._dtensor(cache[k], names, shape) for k in ("k", "v")})

    def init_cache(self, batch: int, max_seq: int) -> dict:
        f = self.cfg.family
        if f in _TRANSFORMER:
            return transformer.dense_init_cache(self.cfg, batch, max_seq, device=self.device)
        if f == "ssm":
            return {**ssm.init_ssm_state(self.cfg, self.cfg.n_layers, batch, self.device),
                    "index": 0}
        if f == "encdec":
            return encdec.encdec_init_cache(self.cfg, batch, max_seq, device=self.device)
        return hybrid.hybrid_init_cache(self.cfg, batch, max_seq, device=self.device)

    def loss(self, params, batch: dict) -> tuple[torch.Tensor, dict]:
        """(loss, metrics) of a training batch: the differentiable fp32 mean
        cross-entropy with z-loss (plus the router's aux term for an MoE
        config) and its detached metrics.  Gradients reach the parameters
        that require them (``Trainer`` turns them on)."""
        f = self.cfg.family
        b = {name: (_tokens(v, self.device) if name in ("tokens", "labels")
                    else _tensor(v, self.device)) for name, v in batch.items()}
        if f in _TRANSFORMER:
            sh = self.shards
            rows = b["tokens"].shape[0]
            if rows % sh.batch_size:
                # each rank would hold every row, and the gradients' sums over
                # the batch axes would count each row batch_size times
                raise ValueError(f"a batch of {rows} rows does not split over the "
                                 f"{sh.batch_size} batch shards of the mesh")
            return transformer.dense_loss(transformer.local_params(params, self.cfg, sh),
                                          self._local_batch(sh, b), self.cfg, sh)
        if f == "ssm":
            return _ssm_loss(params, b, self.cfg)
        if f == "encdec":
            return encdec.encdec_loss(params, b, self.cfg)
        return hybrid.hybrid_loss(params, b, self.cfg)

    @torch.inference_mode()
    def prefill(self, params, batch: dict, max_seq: int):
        f = self.cfg.family
        tokens = _tokens(batch["tokens"], self.device)
        if f in _TRANSFORMER:
            extra = {name: _tensor(batch[name], self.device)
                     for name in ("img_embeds", "positions") if name in batch}
            sh = self.shards
            local = self._local_batch(sh, {"tokens": tokens, **extra})
            logits, cache = transformer.dense_prefill(
                transformer.local_params(params, self.cfg, sh), local.pop("tokens"), self.cfg,
                max_seq, sh=sh, **local)
            b = tokens.shape[0]
            return self._logits_out(logits, b), self._cache_out(cache, b, max_seq)
        if f == "ssm":
            return _ssm_prefill(params, tokens, self.cfg)
        if f == "encdec":
            if "frames" not in batch:
                raise ValueError(f"{self.cfg.name}: an encdec prefill needs the batch's "
                                 f"'frames' (b, enc_seq, d_model)")
            frames = _tensor(batch["frames"], self.device)
            return encdec.encdec_prefill(params, tokens, frames, self.cfg, max_seq)
        return hybrid.hybrid_prefill(params, tokens, self.cfg, max_seq)

    @torch.inference_mode()
    def decode_step(self, params, tokens, cache: dict):
        f = self.cfg.family
        tokens = _tokens(tokens, self.device)
        if f in _TRANSFORMER:
            sh = self.shards
            local = cache
            if self.mesh is not None:  # the DTensors' local slots, written in place
                local = dict(cache, k=cache["k"].to_local(), v=cache["v"].to_local())
            logits, local = transformer.dense_decode_step(
                transformer.local_params(params, self.cfg, sh), sh.local_batch(tokens), local,
                self.cfg, sh)
            if local is not cache:
                cache = dict(cache, index=local["index"])
            return self._logits_out(logits, tokens.shape[0]), cache
        if f == "ssm":
            return _ssm_decode(params, tokens, cache, self.cfg)
        if f == "encdec":
            return encdec.encdec_decode_step(params, tokens, cache, self.cfg)
        return hybrid.hybrid_decode_step(params, tokens, cache, self.cfg)


def build_model(cfg: ArchConfig, mesh=None, device=None) -> Model:
    """A model on ``device`` (None: the CUDA device), or on ``mesh``, whose
    device type it takes (a ``device`` given beside a mesh must agree)."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} (known: "
                         f"{list(PORTED_FAMILIES)})")
    if mesh is None:
        return Model(cfg=cfg, device=resolve_device(device))
    if cfg.family not in _TRANSFORMER:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family does not run on a mesh yet ({MESH_ITEM}); "
            f"its axes trees are ported (Model.param_axes, Model.cache_axes)")
    kind = mesh.device_type
    if device is not None and torch.device(device).type != kind:
        raise ValueError(f"device {device!r} differs from the mesh's {kind!r}")
    dev = resolve_device("cpu" if kind == "cpu" else "cuda")
    if kind == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return Model(cfg=cfg, device=dev, rules=make_rules(mesh, cfg.sharding_overrides))
