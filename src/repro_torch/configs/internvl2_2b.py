"""InternVL2-2B — InternLM2-1.8B backbone, InternViT frontend stubbed
(input_specs provides precomputed patch embeddings) [arXiv:2404.16821]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, act="silu", norm="rmsnorm",
    rope=True, rope_theta=1e6, max_seq=32768,
    input_mode="embeds",
)
