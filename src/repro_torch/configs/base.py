"""ModelConfig — the framework's architecture description + registry.

One `src/repro_torch/configs/<arch>.py` per assigned architecture exports
`CONFIG` (exact published configuration) and the registry maps
`--arch <id>` to it. `reduced()` derives the small same-family variant used
by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "mistral_nemo_12b", "deepseek_coder_33b", "qwen2_5_14b", "minicpm_2b",
    "grok_1_314b", "deepseek_moe_16b", "internvl2_2b", "zamba2_1p2b",
    "mamba2_370m", "musicgen_large",
]

# shapes assigned to the LM-transformer family (all 10 archs)
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# archs allowed to run long_500k (sub-quadratic sequence mixing)
SUBQUADRATIC = {"zamba2_1p2b", "mamba2_370m"}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    act: str = "silu"            # silu (SwiGLU) | gelu | relu
    norm: str = "rmsnorm"
    rope: bool = True
    rope_theta: float = 10000.0
    max_seq: int = 131072
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_ff: int = 0
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    conv_width: int = 4
    # hybrid
    attn_every: int = 0          # shared attn block period (zamba2)
    # modality
    input_mode: str = "tokens"   # tokens | embeds (vlm/audio stub frontends)
    n_codebooks: int = 0         # audio heads

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (Megatron convention) so the
        embedding/lm_head shard cleanly over the model axis; rows >= vocab
        are dead classes (never referenced by tokens/labels)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def reduced(self) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else 4),
            d_model=128,
            n_heads=min(self.n_heads, 4) or 0,
            n_kv_heads=(min(self.n_kv_heads, 2)
                        if self.n_kv_heads < self.n_heads else
                        min(self.n_heads, 4)) or 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            expert_ff=min(self.expert_ff, 64) if self.expert_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            max_seq=1024,
            attn_every=2 if self.attn_every else 0,
        )


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def arch_shapes(arch: str) -> dict:
    """The (shape -> spec) cells this arch runs; long_500k is sub-quadratic
    only (full-attention archs record an explicit skip — DESIGN.md §4)."""
    arch = arch.replace("-", "_").replace(".", "_")
    out = {}
    for shape, spec in SHAPES.items():
        if shape == "long_500k" and arch not in SUBQUADRATIC:
            out[shape] = dict(spec, skip="full-attention arch: 512k dense "
                                          "KV decode outside contract")
        else:
            out[shape] = spec
    return out
