"""PrecisionPolicy — the framework-level contract for Flex-PE precision
modes (the hardware's precision_sel / Sel_AF registers as a per-model
policy object).

`qmatmul` is the single matmul entry point of the models and `qeinsum`
its sibling for the MoE expert banks. The policy's `backend` field
('reference' or 'kernels', see `core.backend`) picks the implementation;
weights may be float tensors or quantize-once `QuantizedTensor`s on
either backend. `PrecisionPolicy.act` and `.softmax` are the activation
and softmax ops of the MoE family and of integer attention.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .activation import default_stages, flex_af, softmax_lv_stages
from .backend import resolve as _resolve_backend
from .fxp import FORMATS, fake_quant, quantize
from .qtensor import QuantizedTensor
from .tiers import TIER_LADDER, TIERS, PrecisionTier, tier_index

__all__ = ["PrecisionPolicy", "qmatmul", "qeinsum", "QuantizedActivation",
           "quantize_activation", "PrecisionTier", "TIERS", "TIER_LADDER",
           "tier_index", "tier_policy", "policy_tier"]


def _dispatch():
    # lazy: core stays importable without the kernel modules
    from ..kernels import dispatch
    return dispatch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-layer-kind precision configuration (hardware mode registers).

    matmul/af/kv_cache: FxP format names or None (native bf16/f32).
    af_impl: 'cordic' (paper datapath) or 'exact'.
    attn_softmax: 'cordic' runs attention's exp and divide on the CORDIC
      datapath; 'exact' uses exp and a true divide.
    int_attention: decode attention on integer KV codes.
    backend: 'reference' or 'kernels' (see `core.backend`).
    """
    name: str = "bf16"
    matmul: Optional[str] = None
    af: Optional[str] = None
    af_impl: str = "exact"
    attn_softmax: str = "exact"
    kv_cache: Optional[str] = None
    int_attention: bool = False
    backend: str = "reference"

    @staticmethod
    def bf16(backend: str = "reference") -> "PrecisionPolicy":
        """Native-precision baseline (no Flex-PE datapath)."""
        return PrecisionPolicy(name="bf16", backend=backend)

    @staticmethod
    def flexpe(bits: int = 8, af_impl: str = "cordic",
               backend: str = "reference") -> "PrecisionPolicy":
        """Paper-faithful FxP<bits> mode: quantized matmuls + CORDIC AFs."""
        fmt = f"fxp{bits}"
        return PrecisionPolicy(
            name=f"flexpe-{fmt}", matmul=fmt, af=fmt, af_impl=af_impl,
            attn_softmax=af_impl if af_impl == "cordic" else "exact",
            kv_cache=fmt if bits >= 8 else "fxp8", backend=backend)

    @staticmethod
    def edge4(backend: str = "reference") -> "PrecisionPolicy":
        """FxP4 edge-inference mode (paper §III-B)."""
        return PrecisionPolicy(name="flexpe-fxp4", matmul="fxp4", af="fxp4",
                               af_impl="cordic", attn_softmax="cordic",
                               kv_cache="fxp8", backend=backend)

    @staticmethod
    def from_name(name: str, backend: str = "reference") -> "PrecisionPolicy":
        """'bf16' | 'flexpe-fxp<bits>' | 'edge4' (the CLI policy names)."""
        if name == "bf16":
            return PrecisionPolicy.bf16(backend)
        if name.startswith("flexpe-fxp"):
            return PrecisionPolicy.flexpe(int(name[len("flexpe-fxp"):]),
                                          backend=backend)
        if name == "edge4":
            return PrecisionPolicy.edge4(backend)
        raise ValueError(f"unknown policy {name!r}")

    def resolved_backend(self) -> str:
        return _resolve_backend(self.backend)

    # -- ops ---------------------------------------------------------------
    def act(self, x: torch.Tensor, af: str, axis: int = -1) -> torch.Tensor:
        """The Flex-PE AF under this policy. CORDIC AFs go to dispatch on
        both backends: the CORDIC AF kernel on the kernels backend, the
        same op with its plain version on the reference backend. (The
        reference package routes only its Pallas backend there; its plain
        backend snaps a bf16 input on the bf16 grid where the kernel op
        snaps in f32, so its two backends disagree on bf16 activations:
        ROADMAP.md queue 3.) Exact AFs take `flex_af`."""
        if self.af_impl == "cordic" and af != "softmax":
            return _dispatch().act(x, af, self,
                                   backend=self.resolved_backend())
        return flex_af(x, af, precision=self.af, impl=self.af_impl,
                       axis=axis)

    def softmax(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """Softmax under this policy: exact unless `attn_softmax` is
        'cordic'. A CORDIC softmax over the last axis goes to dispatch on
        both backends (the kernel, or the same op with its plain version,
        both summing each row in the kernel's fixed order); over another
        axis it is `flex_af` with LV stages for the row length."""
        if self.attn_softmax != "cordic":
            return flex_af(x, "softmax", precision=None, impl="exact",
                           axis=axis)
        if axis in (-1, x.dim() - 1):
            return _dispatch().softmax(x, self,
                                       backend=self.resolved_backend())
        hr, _ = default_stages(self.af)
        lv = softmax_lv_stages(x.shape[axis], self.af)
        return flex_af(x, "softmax", precision=self.af, impl="cordic",
                       stages=(hr, lv), axis=axis)


def tier_policy(tier: str, backend: str = "reference",
                af_impl: str = "cordic") -> PrecisionPolicy:
    """The `PrecisionPolicy` a replica pinned to ladder tier `tier` runs."""
    t = TIER_LADDER[tier_index(tier)]
    if t.bits is None:
        return PrecisionPolicy.bf16(backend)
    return PrecisionPolicy.flexpe(t.bits, af_impl=af_impl, backend=backend)


def policy_tier(policy: Optional[PrecisionPolicy]) -> Optional[str]:
    """Ladder tier a policy serves at: its matmul format when that is a
    rung, 'bf16' for native-precision policies, None off the ladder."""
    if policy is None or policy.matmul is None:
        return "bf16"
    return policy.matmul if policy.matmul in TIERS else None


class QuantizedActivation(NamedTuple):
    """An activation [..., K] quantized once, per tensor, for several
    GEMMs that read it (q/k/v, the SwiGLU gate and up projections):
    codes [rows, K], the f32 scale, and the leading shape and dtype of
    the activation it came from."""
    codes: torch.Tensor
    scale: torch.Tensor
    lead: tuple
    dtype: torch.dtype


def quantize_activation(x: torch.Tensor, w,
                        policy: Optional[PrecisionPolicy]):
    """`x` quantized the way `qmatmul(x, w, policy)` quantizes it, when
    that is the integer path (a quantize-once weight: int8 codes up to
    FxP8, int16 codes for FxP12 and FxP16, int32 codes for FxP24 and
    FxP32), per tensor, with the true divide of `core.fxp.quantize`;
    otherwise `x` unchanged. Every `qmatmul` of the result against such
    weights gives what it gives on `x`, bit for bit."""
    if not isinstance(w, QuantizedTensor):
        return x
    fmt_x = FORMATS[policy.matmul if policy is not None
                    and policy.matmul is not None else w.fmt_name]
    *lead, kdim = x.shape
    codes, scale = quantize(x.reshape(-1, kdim).float(), fmt_x)
    return QuantizedActivation(codes, scale, tuple(lead), x.dtype)


def qmatmul(x, w, policy: Optional[PrecisionPolicy],
            af: Optional[str] = None) -> torch.Tensor:
    """Policy-aware matmul x [..., K] @ w [K, N] -> [..., N] in x.dtype.

    Quantize-once weights, a fused activation, the kernels backend or a
    `QuantizedActivation` go through `kernels.dispatch`. Otherwise: the
    fake-quant float path (operands snapped to the policy's FxP grid, f32
    accumulation)."""
    be = _resolve_backend(policy.backend if policy is not None else None)
    if (be == "kernels" or isinstance(w, QuantizedTensor) or af is not None
            or isinstance(x, QuantizedActivation)):
        return _dispatch().matmul(x, w, policy, backend=be, af=af)
    if policy is not None and policy.matmul is not None:
        x = fake_quant(x, FORMATS[policy.matmul])
        w = fake_quant(w, FORMATS[policy.matmul])
    return torch.matmul(x.float(), w.float()).to(x.dtype)


#: MoE expert-bank einsums: batched per-expert GEMMs with the contraction
#: on x's last / w's middle axis, served by `kernels.dispatch.expert_matmul`.
_EXPERT_BANK_SPECS = frozenset({"gecd,edf->gecf", "gecf,efd->gecd"})


def qeinsum(spec: str, x: torch.Tensor, w,
            policy: Optional[PrecisionPolicy]) -> torch.Tensor:
    """Einsum sibling of `qmatmul`. The MoE expert-bank specs on the
    kernels backend or with a `QuantizedTensor` bank go to
    `kernels.dispatch.expert_matmul` (the same exact-integer contract as
    `qmatmul`); anything else is the fake-quant f32 einsum."""
    be = _resolve_backend(policy.backend if policy is not None else None)
    if spec in _EXPERT_BANK_SPECS and (be == "kernels"
                                       or isinstance(w, QuantizedTensor)):
        return _dispatch().expert_matmul(x, w, policy, backend=be)
    if isinstance(w, QuantizedTensor):
        w = w.dequantize(x.dtype)
    xq, wq = x, w
    if policy is not None and policy.matmul is not None:
        xq = fake_quant(x, FORMATS[policy.matmul])
        wq = fake_quant(w, FORMATS[policy.matmul])
    return torch.einsum(spec, xq.float(), wq.float()).to(x.dtype)
