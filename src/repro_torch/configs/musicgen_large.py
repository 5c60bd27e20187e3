"""MusicGen-large — decoder-only over EnCodec tokens (4 codebooks, delay
pattern); EnCodec frontend stubbed (input_specs provides frame embeddings)
[arXiv:2306.05284]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, act="gelu", norm="layernorm",
    rope=False, max_seq=16384,
    input_mode="embeds", n_codebooks=4,
)
