"""DeepSeek-Coder 33B (llama-arch) [arXiv:2401.14196]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256, act="silu", norm="rmsnorm",
    rope=True, rope_theta=1e5, max_seq=16384,
)
