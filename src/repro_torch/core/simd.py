"""SIMD lane packing — the storage side of the paper's 32-bit datapath.

One int32 word carries 8xFxP4 / 4xFxP8 / 2xFxP16 / 1xFxP32 lanes
(two's-complement nibbles/bytes/halves). Lane j of word w holds element
w*L + j, lane 0 in the least-significant bits.
"""
from __future__ import annotations

import torch

from .fxp import FxPFormat

__all__ = ["pack", "unpack"]


def pack(codes: torch.Tensor, fmt: FxPFormat) -> torch.Tensor:
    """Pack int codes (last axis) into int32 words, lanes on the last axis.
    The last-axis length must be a multiple of the lane count."""
    lanes = 32 // fmt.bits
    if lanes == 1:
        return codes.to(torch.int32)
    *lead, n = codes.shape
    if n % lanes:
        raise ValueError(f"last axis {n} not a multiple of {lanes} lanes")
    mask = (1 << fmt.bits) - 1
    # int64 keeps the shifted top lane from overflowing before the wrap
    c = (codes.to(torch.int64) & mask).reshape(*lead, n // lanes, lanes)
    shifts = torch.arange(lanes, dtype=torch.int64,
                          device=codes.device) * fmt.bits
    words = (c << shifts).sum(dim=-1)          # disjoint bit fields: OR == sum
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack(words: torch.Tensor, fmt: FxPFormat,
           n: int | None = None) -> torch.Tensor:
    """Unpack int32 words back to sign-extended int32 codes (last axis)."""
    lanes = 32 // fmt.bits
    if lanes == 1:
        return words.to(torch.int32)
    *lead, nw = words.shape
    shifts = torch.arange(lanes, dtype=torch.int32,
                          device=words.device) * fmt.bits
    v = (words[..., None] >> shifts) & ((1 << fmt.bits) - 1)
    sign_bit = 1 << (fmt.bits - 1)
    v = torch.where(v >= sign_bit, v - (1 << fmt.bits), v)
    out = v.reshape(*lead, nw * lanes).to(torch.int32)
    if n is not None:
        out = out[..., :n]
    return out
