"""DeepSeekMoE 16B — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, act="silu", norm="rmsnorm",
    rope=True, rope_theta=1e4, max_seq=4096,
    n_experts=64, top_k=6, n_shared_experts=2, expert_ff=1408,
)
