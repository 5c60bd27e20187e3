"""cordic_af: the Flex-PE CORDIC activation function, element by element.

`cordic_af` is the op (the reference's `cordic_af/ops.cordic_af`): the
input snapped to the policy's FxP grid per tensor in f32, the AF, the
result snapped again, cast back to the input dtype. Stages default to the
paper's Pareto point for the format (`PARETO_STAGES`). On a CUDA tensor
(bf16 or f32) the whole op is one launch of the hand-written Hopper
kernel (`csrc/cordic_af.cu`: both snaps, their per-tensor maxima reduced
across a cooperative grid, the AF and the cast), which raises rather than
fall back; on a CPU tensor it is `_op` around `cordic_af_plain`, the same
f32 operations in plain PyTorch. The two agree bit for bit with the plain
op on the same device (the kernel's `apply_af` and snaps round each
operation as PyTorch does there, and the build forbids FMA contraction).

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
from ..build import cordic_params, library, op_slots

__all__ = ["KERNEL_AFS", "AF_CODE", "cordic_af", "cordic_af_plain",
           "cordic_af_reference"]

#: AFs the kernel computes (the Flex-PE Sel_AF set minus softmax).
KERNEL_AFS = ("relu", "sigmoid", "tanh", "silu", "gelu", "exp")
AF_CODE = {None: 0, "relu": 1, "sigmoid": 2, "tanh": 3, "silu": 4,
           "gelu": 5, "exp": 6}                 # enum AfCode in cordic.cuh

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"cordic_af_op": ([_P, _P, _P, _I, ctypes.c_longlong]
                                + [_I] * 4 + [_F, _F, _P, _P], ctypes.c_int)}
#: the kernels' dtype codes (`dtype` of the C entries)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def stages(precision: Optional[str], hr_stages: Optional[int],
           lv_stages: Optional[int]) -> tuple[int, int]:
    """(hr, lv): the given counts, else the format's Pareto point."""
    hr_d, lv_d, _ = PARETO_STAGES[FORMATS[precision].bits if precision
                                  else 16]
    return (hr_stages if hr_stages is not None else hr_d,
            lv_stages if lv_stages is not None else lv_d)


def snap_args(x: torch.Tensor, precision: Optional[str]):
    """(slots, dtype code, snap flag, qmin, qmax) of a CUDA op launch on
    `x`; raises for a dtype the kernels do not load. The caller keeps
    `slots` alive until it has launched."""
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the CORDIC kernels take bf16 or f32, not "
                         f"{x.dtype}")
    fmt = FORMATS[precision] if precision is not None else None
    return (op_slots(x.device), KERNEL_DTYPES[x.dtype], int(fmt is not None),
            float(fmt.qmin) if fmt else 0.0, float(fmt.qmax) if fmt else 0.0)


def _kernel(x: torch.Tensor, af: str, precision: Optional[str], hr: int,
            lv: int) -> torch.Tensor:
    """One launch of the whole op over the CUDA tensor `x`, same shape and
    dtype."""
    slots, dtype, snap, qmin, qmax = snap_args(x, precision)
    x = x.contiguous()
    out = torch.empty_like(x)
    err = library("cordic_af", _SIGNATURES).cordic_af_op(
        x.data_ptr(), out.data_ptr(), slots.data_ptr(), slots.numel(),
        x.numel(), dtype, AF_CODE[af], lv, snap, qmin, qmax,
        ctypes.byref(cordic_params(hr)),
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
    hr, lv = stages(precision, hr_stages, lv_stages)
    xf = x.float()
    if precision is not None:
        xf = fake_quant(xf, FORMATS[precision])
    out = af_fn(xf, af, hr, lv)
    if precision is not None:
        out = fake_quant(out, FORMATS[precision])
    return out.to(x.dtype)


def cordic_af(x: torch.Tensor, af: str, precision: Optional[str] = None,
              hr_stages: Optional[int] = None,
              lv_stages: Optional[int] = None) -> torch.Tensor:
    """AF(x) on the Flex-PE datapath, any shape, in x.dtype. A CUDA tensor
    takes one launch of the op's kernel; a CPU tensor runs the plain op."""
    if x.device.type == "cpu":
        return _op(x, af, precision, hr_stages, lv_stages, cordic_af_plain)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if af not in KERNEL_AFS:
        raise ValueError(f"unsupported af {af!r}")
    return _kernel(x, af, precision, *stages(precision, hr_stages, lv_stages))


cordic_af.launches = 0


def cordic_af_reference(x: torch.Tensor, af: str,
                        precision: Optional[str] = None,
                        hr_stages: Optional[int] = None,
                        lv_stages: Optional[int] = None) -> torch.Tensor:
    """`cordic_af` with the plain version on any device: the plain
    backend's op, bit-equal to the kernels backend's."""
    return _op(x, af, precision, hr_stages, lv_stages, cordic_af_plain)
