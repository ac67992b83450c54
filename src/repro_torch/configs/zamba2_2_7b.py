"""zamba2-2.7b: hybrid — 54 Mamba2 layers + one SHARED attention block applied
every 6 layers. 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.
[arXiv:2411.15242; hf].  Sub-quadratic backbone -> runs long_500k."""
from .base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    shared_attn_every=6,
    ssm=SSMCfg(d_state=64, expand=2, headdim=64, ngroups=8, conv_width=4, chunk=256),
    optimizer="adamw",
    remat="dots",
    long_context_ok=True,
    source="arXiv:2411.15242; hf",
)
