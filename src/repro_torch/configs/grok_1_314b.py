"""Grok-1 314B MoE 8e top-2 [hf:xai-org/grok-1; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072, act="gelu", norm="rmsnorm",
    rope=True, rope_theta=1e4, max_seq=8192,
    n_experts=8, top_k=2, expert_ff=32768,
)
