"""Fixed-point (FxP) formats and quantization for Flex-PE (PyTorch).

An FxP<N> tensor is a signed two's-complement integer grid with a
per-tensor (or per-channel) dynamic scale, rounded to nearest even.

Two views of an FxP tensor:
  * fake-quant float — float values snapped to the FxP grid.
  * integer codes    — narrowest-int codes + f32 scale (quantize-once
    weight storage, the int8 KV pool, the GEMM kernel's operands).

`quantize` keeps the true divide `x / scale`: a multiply by the
reciprocal rounds differently and would move codes.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "FxPFormat", "FXP4", "FXP8", "FXP12", "FXP16", "FXP24", "FXP32",
    "FORMATS", "quantize", "dequantize", "fake_quant", "code_dtype",
    "dynamic_scale",
]


@dataclasses.dataclass(frozen=True)
class FxPFormat:
    """Signed fixed-point format: `bits` total, `frac` fractional bits."""
    name: str
    bits: int
    frac: int

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def lanes_per_word(self) -> int:
        """SIMD lanes in one 32-bit word: 8x4b / 4x8b / 2x16b / 1x32b."""
        return 32 // self.bits


FXP4 = FxPFormat("fxp4", 4, 2)
FXP8 = FxPFormat("fxp8", 8, 6)
FXP12 = FxPFormat("fxp12", 12, 10)
FXP16 = FxPFormat("fxp16", 16, 14)
FXP24 = FxPFormat("fxp24", 24, 22)
FXP32 = FxPFormat("fxp32", 32, 30)

FORMATS = {f.name: f for f in (FXP4, FXP8, FXP12, FXP16, FXP24, FXP32)}


def dynamic_scale(x: torch.Tensor, fmt: FxPFormat, axis=None) -> torch.Tensor:
    """Per-tensor (axis=None) or per-axis scale so max|x| maps to qmax."""
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    amax = torch.clamp_min(amax.float(), 1e-12)
    return amax / fmt.qmax


def code_dtype(fmt: FxPFormat) -> torch.dtype:
    """Narrowest int dtype holding the codes (int8 for FxP<=8)."""
    return torch.int8 if fmt.bits <= 8 else (
        torch.int16 if fmt.bits <= 16 else torch.int32)


def quantize(x: torch.Tensor, fmt: FxPFormat, scale=None, axis=None):
    """-> (int codes (narrowest dtype), scale). Clipped to [qmin, qmax];
    `torch.round` rounds half to even, as the reference grid does.

    Past 24 bits qmax is not an f32: FxP32's 2^31 - 1 rounds to 2^31, so
    the f32 clamp lets 2^31 through, which the f32 -> int32 cast wraps to
    -2^31 on the CPU. XLA's cast saturates it to 2^31 - 1; so do these
    codes, clamped again in int64, on every device."""
    if scale is None:
        scale = dynamic_scale(x, fmt, axis=axis)
    codes = torch.round(x.float() / scale)
    codes = torch.clamp(codes, fmt.qmin, fmt.qmax)
    if fmt.bits > 24:
        codes = codes.to(torch.int64).clamp_(fmt.qmin, fmt.qmax)
    return codes.to(code_dtype(fmt)), scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (codes.float() * scale).to(dtype)


def fake_quant(x: torch.Tensor, fmt: FxPFormat, scale=None,
               axis=None) -> torch.Tensor:
    """Snap x to the FxP grid (forward only; training waits)."""
    codes, s = quantize(x, fmt, scale=scale, axis=axis)
    return dequantize(codes, s, dtype=x.dtype)
