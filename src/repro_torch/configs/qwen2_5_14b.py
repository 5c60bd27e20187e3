"""Qwen2.5-14B — GQA with QKV bias [hf:Qwen/Qwen2.5-14B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, qkv_bias=True, act="silu", norm="rmsnorm",
    rope=True, rope_theta=1e6, max_seq=131072,
)
