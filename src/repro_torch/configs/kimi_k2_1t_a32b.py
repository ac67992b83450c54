"""kimi-k2-1t-a32b: trillion-param MoE. 61L d_model=7168 64H (GQA kv=8),
384 experts top-8, d_ff_expert=2048, 1 shared expert, vocab=163840.
[arXiv:2501.kimi2; unverified]
E=384 shards 16-way over the model axis -> 'ep' mode (token all_to_all)."""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,   # dense-layer ff unused; experts carry the FFN capacity
    vocab=163840,
    head_dim=112,
    moe=MoECfg(n_experts=384, top_k=8, d_ff_expert=2048, mode="ep",
               n_shared_experts=1, capacity_factor=1.25),
    optimizer="adafactor",
    remat="full",
    microbatches=8,
    source="arXiv:2501.kimi2; unverified",
)
