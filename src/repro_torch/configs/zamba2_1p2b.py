"""Zamba2-1.2B — Mamba2 backbone + shared attention block
[arXiv:2411.15242]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, act="gelu", norm="rmsnorm",
    rope=True, rope_theta=1e4, max_seq=524288,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
    attn_every=6,
)
