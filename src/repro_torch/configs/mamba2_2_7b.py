"""mamba2-2.7b: attention-free SSM (SSD), 64L d_model=2560, ssm_state=128.
[arXiv:2405.21060; unverified].  Sub-quadratic -> runs long_500k."""
from .base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMCfg(d_state=128, expand=2, headdim=64, ngroups=8, conv_width=4, chunk=256),
    optimizer="adamw",
    remat="dots",
    long_context_ok=True,
    source="arXiv:2405.21060; unverified",
)
