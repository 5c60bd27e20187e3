"""MiniCPM-2B (llama-like, WSD schedule) [arXiv:2404.06395]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753, act="silu", norm="rmsnorm",
    rope=True, rope_theta=1e4, max_seq=4096, tie_embeddings=True,
)
