"""phi3-medium-14b: dense 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352. RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]
40 Q heads pad to 48 / KV 10 -> 12 for the 16-way model axis (zero wo rows)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    head_dim=128,
    rope_theta=1e6,
    optimizer="adamw",
    remat="dots",
    source="arXiv:2404.14219; unverified",
)
