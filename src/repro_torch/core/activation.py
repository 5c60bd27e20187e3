"""Runtime-configurable multi-precision activation functions (paper §III).

`flex_af` is the software contract of the Flex-PE AF datapath: one entry
point, AF selected by `af` (the Sel_AF register), precision by
`precision`, CORDIC stage counts defaulting to the paper's Pareto points.

CORDIC compositions (paper Fig. 4), with range-extended exp
(z = k ln2 + r, e^z = 2^k e^r):
  sigmoid(x) : e^min(x,0) / (1 + e^-|x|)     HR exp + LV divide
  tanh(x)    : sign(x) (1 - t)/(1 + t), t = e^-2|x|
  softmax(x) : HR exp of x - max, row sum, LV divide
  relu(x)    : mux
  silu/gelu  : x * sigmoid(x) / x * sigmoid(1.702 x)
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import cordic
from .cordic import PARETO_STAGES
from .fxp import FORMATS, fake_quant

__all__ = ["flex_af", "cordic_sigmoid", "cordic_tanh", "cordic_softmax",
           "cordic_exp", "default_stages", "softmax_lv_stages"]


def default_stages(precision: Optional[str]) -> tuple[int, int]:
    """(hr_stages, lv_stages) from the paper's Pareto analysis."""
    bits = FORMATS[precision].bits if precision else 16
    hr, lv, _ = PARETO_STAGES[bits]
    return hr, lv


def softmax_lv_stages(row_len: int, precision: Optional[str] = None) -> int:
    """LV stages for an N-way softmax: log2(N) + 6 guard bits, at least the
    Pareto point, at most 24 (the FxP32 fraction width)."""
    _, lv, _ = PARETO_STAGES[FORMATS[precision].bits if precision else 16]
    need = int(math.ceil(math.log2(max(row_len, 2)))) + 6
    return max(lv, min(need, 24))


def cordic_exp(x, hr_stages=4):
    return cordic.extended_exp_float(x, hr_stages)


def cordic_sigmoid(x, hr_stages=4, lv_stages=5):
    # exp arg <= 0 (no overflow) and |num| <= |den| (LV convergence)
    e = cordic.extended_exp_float(-x.abs(), hr_stages)
    num = torch.where(x >= 0, torch.ones_like(e), e)
    den = 1.0 + e
    return cordic.lv_divide_float(num, den, lv_stages)


def cordic_tanh(x, hr_stages=4, lv_stages=5):
    t = cordic.extended_exp_float(-2.0 * x.abs(), hr_stages)
    mag = cordic.lv_divide_float(1.0 - t, 1.0 + t, lv_stages)
    return torch.sign(x) * mag


def cordic_softmax(x, hr_stages=4, lv_stages=5, axis=-1):
    m = x.amax(dim=axis, keepdim=True)
    e = cordic.extended_exp_float(x - m, hr_stages)
    s = e.sum(dim=axis, keepdim=True)
    return cordic.lv_divide_float(e, s.expand_as(e), lv_stages)


_EXACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "silu": torch.nn.functional.silu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "exp": torch.exp,
}


def flex_af(x: torch.Tensor, af: str, precision: Optional[str] = None,
            impl: str = "cordic", stages: Optional[tuple[int, int]] = None,
            axis: int = -1) -> torch.Tensor:
    """The Flex-PE activation-function datapath.

    af: sigmoid | tanh | relu | softmax | silu | gelu | exp | identity;
    precision: FxP format name or None (no quantization); impl: 'cordic'
    (paper datapath) or 'exact'; stages: optional (hr, lv) override of
    the Pareto point."""
    if af == "identity":
        return x
    orig_dtype = x.dtype
    if precision is not None:
        x = fake_quant(x, FORMATS[precision])
    if af == "relu":
        out = torch.clamp_min(x, 0)
    elif impl == "exact":
        xf = x.float()
        out = (torch.softmax(xf, dim=axis) if af == "softmax"
               else _EXACT[af](xf))
    else:
        hr, lv = stages if stages is not None else default_stages(precision)
        xf = x.float()
        if af == "sigmoid":
            out = cordic_sigmoid(xf, hr, lv)
        elif af == "tanh":
            out = cordic_tanh(xf, hr, lv)
        elif af == "softmax":
            out = cordic_softmax(xf, hr, lv, axis)
        elif af == "exp":
            out = cordic_exp(xf, hr)
        elif af == "silu":
            out = xf * cordic_sigmoid(xf, hr, lv)
        elif af == "gelu":
            out = xf * cordic_sigmoid(1.702 * xf, hr, lv)
        else:
            raise ValueError(f"unknown af {af!r}")
    if precision is not None:
        out = fake_quant(out, FORMATS[precision])
    return out.to(orig_dtype)
