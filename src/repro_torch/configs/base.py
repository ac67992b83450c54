"""Architecture configuration (the port's copy of ``repro.configs.base``).

``ArchConfig`` and its sub-configs are field-for-field copies of the
reference's, so ``dataclasses.asdict`` of a port config equals the
reference's.  Every architecture of the reference has its config module
here, and the port runs all six families.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

__all__ = [
    "ARCH_IDS",
    "PORTED_FAMILIES",
    "ArchConfig",
    "MoECfg",
    "SSMCfg",
    "get_config",
    "reduced_config",
]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    min_capacity: int = 4
    mode: str = "ep"
    n_shared_experts: int = 0
    router_aux_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    expand: int = 2
    headdim: int = 64
    ngroups: int = 8
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope: bool = False
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    shared_attn_every: int = 0  # zamba2: shared attention block period
    enc_layers: int = 0
    enc_seq: int = 1500
    img_tokens: int = 0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    optimizer: str = "adamw"
    remat: str = "full"
    microbatches: int = 1
    sharding_overrides: dict[str, tuple[str, ...]] = dataclasses.field(default_factory=dict)
    unroll_layers: bool = False
    attn_chunk: int = 1024
    long_context_ok: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // max(self.n_heads, 1)

    def padded(self, dim: int, multiple: int) -> int:
        return ((dim + multiple - 1) // multiple) * multiple

    def vocab_padded(self, model_shards: int = 16) -> int:
        """Vocab rounded up as the reference rounds it (rows beyond ``vocab``
        are masked out of sampling)."""
        return self.padded(self.vocab, max(128, model_shards))

    def heads_padded(self, model_shards: int = 16) -> int:
        """Q heads padded as the reference pads them (zero output rows)."""
        if self.n_heads % model_shards == 0 or self.n_heads < model_shards:
            return self.n_heads
        return self.padded(self.n_heads, model_shards)


ARCH_IDS = [
    "qwen3-32b",
    "minitron-8b",
    "phi3-medium-14b",
    "codeqwen1.5-7b",
    "mamba2-2.7b",
    "zamba2-2.7b",
    "qwen2-vl-2b",
    "whisper-tiny",
    "grok-1-314b",
    "kimi-k2-1t-a32b",
]

# each architecture's config module
_MODULE_FOR = {
    "qwen3-32b": "qwen3_32b",
    "minitron-8b": "minitron_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "zamba2-2.7b": "zamba2_2_7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-tiny": "whisper_tiny",
    "grok-1-314b": "grok_1_314b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
}
PORTED_FAMILIES = ("hybrid", "dense", "ssm", "moe", "vlm", "encdec")


def get_config(name: str) -> ArchConfig:
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"{__package__}.{_MODULE_FOR[name]}").CONFIG


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU tests (the reference's rules)."""
    kw: dict[str, Any] = dict(
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=128,
        vocab=256,
        head_dim=16,
        microbatches=1,
        enc_layers=min(cfg.enc_layers, 2),
        enc_seq=16 if cfg.family == "encdec" else cfg.enc_seq,
        img_tokens=8 if cfg.family == "vlm" else 0,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        remat="none",
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8 if cfg.moe.mode == "ep" else 4, top_k=2,
            d_ff_expert=32, capacity_factor=4.0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, headdim=8, ngroups=2, chunk=8)
    return dataclasses.replace(cfg, **kw)
