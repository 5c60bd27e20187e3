"""Quantize-once weight storage — the SIMD-packed serving format.

`QuantizedTensor` replaces a float matmul weight with integer codes plus
a per-output-channel scale, so serving moves the codes instead of
re-quantizing a bf16 tensor every step:

    FxP4  packed nibbles (`core.simd.pack` int32 words)   8x fewer bytes
    FxP8  int8 codes                                      4x fewer bytes
    FxP16 int16 codes                                     2x fewer bytes

Codes come from `core.fxp.quantize` with a per-output-channel dynamic
scale (axis -2 of a [K, N] weight), so dequant is `codes * scale[1, N]`.
Stacked layer weights [L, K, N] quantize per (layer, channel) and keep
the leading layer axis; `layer(i)` slices both leaves together.

`quantize_params` is the model-surgery pass over the keys in
`QUANT_PARAM_KEYS`; embeddings, norms and biases stay float.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from .fxp import FORMATS, FxPFormat, code_dtype, quantize
from .simd import pack, unpack

__all__ = ["QuantizedTensor", "quantize_tensor", "quantize_params",
           "map_weight_leaves", "packed_bytes", "QUANT_PARAM_KEYS"]

#: Param-tree dict keys that hold matmul weights (consumed by `qmatmul`).
QUANT_PARAM_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w1", "w2", "w3", "lm_head", "in_proj",
     "out_proj"})


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Integer weight codes + per-channel scale (one FxP-quantized matrix).

    data:  codes in the narrowest int dtype ([.., K, N]), or for packed
           FxP4 `core.simd.pack` int32 words ([.., K, ceil(N/8)]).
    scale: f32 per-output-channel scale, broadcastable [.., 1, N]
           (or [.., 1, 1] for per-tensor quantization).
    fmt_name / n / packed: format, logical output features, packing.
    """
    data: torch.Tensor
    scale: torch.Tensor
    fmt_name: str
    n: int
    packed: bool

    @property
    def fmt(self) -> FxPFormat:
        return FORMATS[self.fmt_name]

    @property
    def shape(self) -> tuple:
        """Logical (unpacked, unpadded) shape."""
        return tuple(self.data.shape[:-1]) + (self.n,)

    @property
    def ndim(self) -> int:
        return self.data.dim()

    @property
    def nbytes(self) -> int:
        """Bytes of weight storage moved per use."""
        return int(self.data.numel() * self.data.element_size()
                   + self.scale.numel() * self.scale.element_size())

    def layer(self, i: int) -> "QuantizedTensor":
        """Slice the leading (layer) axis of both leaves."""
        return QuantizedTensor(self.data[i], self.scale[i], self.fmt_name,
                               self.n, self.packed)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.data.to(device), self.scale.to(device),
                               self.fmt_name, self.n, self.packed)

    def codes(self) -> torch.Tensor:
        """Sign-extended integer codes [.., K, N] (unpacks FxP4 words)."""
        if not self.packed:
            return self.data
        return unpack(self.data, self.fmt, self.n)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.codes().float() * self.scale).to(dtype)


def quantize_tensor(w: torch.Tensor, fmt_name: str,
                    packed: Optional[bool] = None) -> QuantizedTensor:
    """Quantize a float weight [.., K, N] once, for serving-time reuse.
    Stacked [L, K, N] weights quantize one layer at a time (the scale is
    per (layer, channel) either way), into one preallocated code tensor,
    which bounds the temporaries of a full-width model to one layer."""
    fmt = FORMATS[fmt_name]
    if packed is None:
        packed = fmt.bits == 4
    if packed and fmt.bits != 4:
        raise ValueError("lane-packed storage is FxP4-only "
                         f"(got {fmt_name})")
    if w.dim() > 2:
        first = quantize_tensor(w[0], fmt_name, packed)
        data = first.data.new_empty((w.shape[0],) + tuple(first.data.shape))
        scale = first.scale.new_empty((w.shape[0],)
                                      + tuple(first.scale.shape))
        data[0], scale[0] = first.data, first.scale
        for i in range(1, w.shape[0]):
            part = quantize_tensor(w[i], fmt_name, packed)
            data[i], scale[i] = part.data, part.scale
        return QuantizedTensor(data, scale, fmt_name, w.shape[-1], packed)
    codes, scale = quantize(w, fmt, axis=-2)             # per channel
    n = w.shape[-1]
    if packed:
        lanes = fmt.lanes_per_word
        pad = (-n) % lanes
        c32 = codes.to(torch.int32)
        if pad:
            c32 = torch.nn.functional.pad(c32, (0, pad))
        data = pack(c32, fmt)
    else:
        data = codes.to(code_dtype(fmt))
    return QuantizedTensor(data, scale.float(), fmt_name, n, packed)


def _is_weight_leaf(v: Any) -> bool:
    return (isinstance(v, torch.Tensor) and v.dim() in (2, 3, 4)
            and v.is_floating_point())


def map_weight_leaves(params: Any, fn, consume: bool = False) -> Any:
    """Rebuild `params` with `fn` applied to every matmul-weight leaf
    (float leaves with ndim >= 2 under a key in `QUANT_PARAM_KEYS`).
    `consume` pops each such leaf from `params` as it is converted, so a
    caller that holds no other reference frees it at once."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k in list(node):
                if k in QUANT_PARAM_KEYS and _is_weight_leaf(node[k]):
                    out[k] = fn(node.pop(k) if consume else node[k])
                else:
                    out[k] = walk(node[k])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def quantize_params(params: Any, fmt_name: str,
                    packed: Optional[bool] = None,
                    consume: bool = False) -> Any:
    """Model surgery: replace matmul-weight leaves with QuantizedTensor.
    `consume` drops each float leaf from `params` once it is quantized
    (a full-width model then never holds both trees whole)."""
    return map_weight_leaves(
        params, lambda w: quantize_tensor(w, fmt_name, packed=packed),
        consume=consume)


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def packed_bytes(params: Any) -> tuple[int, int]:
    """(quantized_bytes, fp32_equivalent_bytes) over QuantizedTensor
    leaves."""
    qb = fb = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QuantizedTensor):
            qb += leaf.nbytes
            fb += 4 * math.prod(leaf.shape)
    return qb, fb
