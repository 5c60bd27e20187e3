"""Mamba2-370M — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, act="silu", norm="rmsnorm",
    rope=False, max_seq=524288,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
)
