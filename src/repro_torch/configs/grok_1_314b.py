"""grok-1-314b: MoE 64L d_model=6144 48H (GQA kv=8) d_ff=32768, 8 experts
top-2, vocab=131072.  [hf:xai-org/grok-1; unverified]
E=8 < 16-way model axis -> 'tp' MoE mode: every chip holds a d_ff shard of
every expert; no expert all_to_all."""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32768, mode="tp", capacity_factor=1.25),
    optimizer="adafactor",
    remat="full",
    microbatches=8,
    source="hf:xai-org/grok-1; unverified",
)
