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
`TieredWeights` holds one such surgery per precision tier of a fleet,
all from one per-channel amax per weight.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from .fxp import FORMATS, FxPFormat, code_dtype, quantize
from .simd import pack, unpack
from .tiers import TIERS, tier_index

__all__ = ["QuantizedTensor", "TieredWeights", "quantize_tensor",
           "quantize_params", "map_weight_leaves", "packed_bytes",
           "QUANT_PARAM_KEYS"]

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
                    packed: Optional[bool] = None,
                    scale: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """Quantize a float weight [.., K, N] once, for serving-time reuse.
    Stacked [L, K, N] weights quantize one layer at a time (the scale is
    per (layer, channel) either way), into one preallocated code tensor,
    which bounds the temporaries of a full-width model to one layer.
    `scale` [.., 1, N] overrides the dynamic per-channel scale (the
    `TieredWeights` banks pass amax / qmax of a shared amax)."""
    fmt = FORMATS[fmt_name]
    if packed is None:
        packed = fmt.bits == 4
    if packed and fmt.bits != 4:
        raise ValueError("lane-packed storage is FxP4-only "
                         f"(got {fmt_name})")
    if w.dim() > 2:
        def part(i):
            return quantize_tensor(w[i], fmt_name, packed,
                                   None if scale is None else scale[i])
        first = part(0)
        data = first.data.new_empty((w.shape[0],) + tuple(first.data.shape))
        scales = first.scale.new_empty((w.shape[0],)
                                       + tuple(first.scale.shape))
        data[0], scales[0] = first.data, first.scale
        for i in range(1, w.shape[0]):
            q = part(i)
            data[i], scales[i] = q.data, q.scale
        return QuantizedTensor(data, scales, fmt_name, w.shape[-1], packed)
    codes, scale = quantize(w, fmt, scale=scale, axis=-2)   # per channel
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


def channel_amax(w: torch.Tensor) -> torch.Tensor:
    """max |w| over the input axis (-2), f32, at least 1e-12: [.., 1, N],
    the amax `core.fxp.dynamic_scale` takes per channel (one leading slice
    at a time, so a stacked full-width leaf needs no |w| copy of itself)."""
    if w.dim() > 2:
        return torch.stack([channel_amax(w[i]) for i in range(w.shape[0])])
    return torch.clamp_min(w.abs().amax(dim=-2, keepdim=True).float(),
                           1e-12)


class _PerTier(dict):
    """One weight leaf's QuantizedTensor per tier (a leaf of the combined
    tree `TieredWeights` splits into its views)."""


def _select(node, tier):
    if isinstance(node, _PerTier):
        return node[tier]
    if isinstance(node, dict):
        return {k: _select(v, tier) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_select(v, tier) for v in node)
    return node


class TieredWeights:
    """Quantize-once weight banks for every serving tier of one model.

    One float source tree and, per quantized ladder tier, a
    `quantize_params`-shaped view whose matmul weights are QuantizedTensor
    codes at that tier's width. The per-channel amax of each float weight
    is taken once and shared: a tier's scale is amax / qmax(tier), the
    same f32 divide `quantize_params` makes, so `for_tier(t)` holds the
    codes and scales of independent surgery at t, bit for bit. The 'bf16'
    tier serves the float source itself. Views share every non-weight
    leaf (embedding, norms, biases) with the source.

    `consume=True` pops each float weight leaf from `params` once all of
    its tier codes exist, so a full-width model never holds its float
    weights and every bank whole (ignored when 'bf16' is a tier: its view
    is the source)."""

    def __init__(self, params: Any, tiers, consume: bool = False):
        names = []
        for t in tiers:
            tier_index(t)                      # unknown tier -> ValueError
            if t not in names:
                names.append(t)
        if not names:
            raise ValueError("TieredWeights needs at least one tier")
        self.tier_names = tuple(names)
        quant = [t for t in names if TIERS[t].bits is not None]
        consume = consume and len(quant) == len(names)

        def banks(w):
            amax = channel_amax(w)
            return _PerTier({t: quantize_tensor(
                w, t, scale=amax / FORMATS[t].qmax) for t in quant})
        combined = map_weight_leaves(params, banks, consume=consume)
        self.source = params
        self._views = {t: params if TIERS[t].bits is None
                       else _select(combined, t) for t in names}

    def __contains__(self, tier: str) -> bool:
        return tier in self._views

    def for_tier(self, tier: str) -> Any:
        """The param tree a replica pinned to `tier` serves from."""
        if tier not in self._views:
            raise ValueError(f"tier {tier!r} not in this TieredWeights "
                             f"(has {list(self.tier_names)})")
        return self._views[tier]

    def bytes_by_tier(self) -> dict:
        """Resident weight bytes per tier view: the QuantizedTensor codes
        and scales of a quantized tier; the whole float source for
        'bf16'."""
        out = {}
        for t in self.tier_names:
            if TIERS[t].bits is None:
                out[t] = sum(leaf.numel() * leaf.element_size()
                             for leaf in _leaves(self.source)
                             if isinstance(leaf, torch.Tensor))
            else:
                out[t] = sum(leaf.nbytes for leaf in _leaves(self._views[t])
                             if isinstance(leaf, QuantizedTensor))
        return out


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
