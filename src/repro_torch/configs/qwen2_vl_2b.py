"""qwen2-vl-2b: VLM backbone 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 with M-RoPE.  Vision frontend is a stub: input_specs() provides
precomputed patch embeddings + (3, b, s) M-RoPE position streams.
[arXiv:2409.12191; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    head_dim=128,
    mrope=True,
    rope_theta=1e6,
    img_tokens=1024,  # stub frontend: 1024 patch embeddings per sample
    optimizer="adamw",
    remat="dots",
    source="arXiv:2409.12191; hf",
)
