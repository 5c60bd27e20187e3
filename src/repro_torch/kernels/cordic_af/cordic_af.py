"""cordic_af: the Flex-PE CORDIC activation function, element by element.

`cordic_af` is the op (the reference's `cordic_af/ops.cordic_af`): the
input snapped to the policy's FxP grid per tensor in f32, the AF, the
result snapped again, cast back to the input dtype. Stages default to the
paper's Pareto point for the format (`PARETO_STAGES`). On a CUDA tensor
the AF is the hand-written Hopper kernel (`csrc/cordic_af.cu`), which
raises rather than fall back; on a CPU tensor it is `cordic_af_plain`,
the same f32 operations in plain PyTorch. The two agree bit for bit (the
kernel's `apply_af` rounds each operation as PyTorch does, and the build
forbids FMA contraction).

`cordic_af_reference` is the same op with the plain version on any
device: the plain backend's AF. `cordic_af_plain` is also the fused GEMM
epilogue's plain AF
(`fxp_gemm.fxp_gemm_fused_plain`), as both kernels share `apply_af`.

Replaces src/repro/kernels/cordic_af/cordic_af.py::cordic_af_pallas.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.activation import cordic_exp, cordic_sigmoid, cordic_tanh
from ...core.cordic import PARETO_STAGES
from ...core.fxp import FORMATS, fake_quant
from ..build import cordic_params, library

__all__ = ["KERNEL_AFS", "AF_CODE", "cordic_af", "cordic_af_plain",
           "cordic_af_reference"]

#: AFs the kernel computes (the Flex-PE Sel_AF set minus softmax).
KERNEL_AFS = ("relu", "sigmoid", "tanh", "silu", "gelu", "exp")
AF_CODE = {None: 0, "relu": 1, "sigmoid": 2, "tanh": 3, "silu": 4,
           "gelu": 5, "exp": 6}                 # enum AfCode in cordic.cuh

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"cordic_af": ([_P, _P, ctypes.c_longlong] + [_I] * 3
                             + [_P, _P], ctypes.c_int)}


def cordic_af_plain(x: torch.Tensor, af: str, hr_stages: int = 4,
                    lv_stages: int = 5) -> torch.Tensor:
    """The CORDIC AF on f32 values, in plain PyTorch (the reference's
    `_af_block` at repeat_iters=True)."""
    if af == "relu":
        return torch.clamp_min(x, 0.0)
    if af == "exp":
        return cordic_exp(x, hr_stages)
    if af == "sigmoid":
        return cordic_sigmoid(x, hr_stages, lv_stages)
    if af == "tanh":
        return cordic_tanh(x, hr_stages, lv_stages)
    if af == "silu":
        return x * cordic_sigmoid(x, hr_stages, lv_stages)
    if af == "gelu":
        return x * cordic_sigmoid(1.702 * x, hr_stages, lv_stages)
    raise ValueError(f"unsupported af {af!r}")


def _kernel(x: torch.Tensor, af: str, hr_stages: int,
            lv_stages: int) -> torch.Tensor:
    """One launch over the f32 CUDA tensor `x` -> AF(x), same shape."""
    x = x.contiguous()
    out = torch.empty_like(x)
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    params = cordic_params(hr_stages)
    err = library("cordic_af", _SIGNATURES).cordic_af(
        x.data_ptr(), out.data_ptr(), x.numel(), vec, AF_CODE[af],
        lv_stages, ctypes.byref(params),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cordic_af launch failed: CUDA error {err}")
    cordic_af.launches += 1
    return out


def _op(x: torch.Tensor, af: str, precision: Optional[str],
        hr_stages: Optional[int], lv_stages: Optional[int],
        af_fn) -> torch.Tensor:
    """The reference op's plumbing around `af_fn(x_f32, af, hr, lv)`:
    Pareto stages, the f32 fake-quant in and out, the cast back."""
    if af not in KERNEL_AFS:
        raise ValueError(f"unsupported af {af!r}")
    bits = FORMATS[precision].bits if precision else 16
    hr_d, lv_d, _ = PARETO_STAGES[bits]
    hr = hr_stages if hr_stages is not None else hr_d
    lv = lv_stages if lv_stages is not None else lv_d
    xf = x.float()
    if precision is not None:
        xf = fake_quant(xf, FORMATS[precision])
    out = af_fn(xf, af, hr, lv)
    if precision is not None:
        out = fake_quant(out, FORMATS[precision])
    return out.to(x.dtype)


def _elementwise(x: torch.Tensor, af: str, hr: int, lv: int):
    if x.device.type == "cpu":
        return cordic_af_plain(x, af, hr, lv)
    if x.device.type == "cuda":
        return _kernel(x, af, hr, lv)
    raise ValueError(f"no kernel for device {x.device}")


def cordic_af(x: torch.Tensor, af: str, precision: Optional[str] = None,
              hr_stages: Optional[int] = None,
              lv_stages: Optional[int] = None) -> torch.Tensor:
    """AF(x) on the Flex-PE datapath, any shape, in x.dtype. CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    return _op(x, af, precision, hr_stages, lv_stages, _elementwise)


cordic_af.launches = 0


def cordic_af_reference(x: torch.Tensor, af: str,
                        precision: Optional[str] = None,
                        hr_stages: Optional[int] = None,
                        lv_stages: Optional[int] = None) -> torch.Tensor:
    """`cordic_af` with the plain version on any device: the plain
    backend's op, bit-equal to the kernels backend's."""
    return _op(x, af, precision, hr_stages, lv_stages, cordic_af_plain)
