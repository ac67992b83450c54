"""whisper-tiny: enc-dec, 4L decoder (+4L encoder) d_model=384 6H d_ff=1536
vocab=51865.  Conv/audio frontend is a stub: input_specs() provides
precomputed frame embeddings (1500, d).  [arXiv:2212.04356; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    enc_layers=4,
    enc_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    rope_theta=1e4,
    optimizer="adamw",
    remat="none",
    sharding_overrides={"heads": (), "w_heads": ()},  # 6 heads < 16-way axis
    source="arXiv:2212.04356; unverified",
)
