"""cordic_softmax: the Flex-PE CORDIC softmax over the last axis.

`cordic_softmax` is the op (the reference's `cordic_softmax/ops.
cordic_softmax`): the input snapped to the FxP grid per tensor in f32,
each row's max, HR-CORDIC exp, row sum and LV-CORDIC divide, the result
snapped again, cast back to the input dtype. LV stages scale with the row
length (`softmax_lv_stages`: 12 for the 64-way MoE router under FxP8).
On a CUDA tensor (bf16 or f32) the whole op is one launch of the
hand-written Hopper kernel (`csrc/cordic_softmax.cu`: both snaps, their
per-tensor maxima reduced across a cooperative grid, the row softmax and
the cast), which raises rather than fall back; on a CPU tensor it is
`_op` around `cordic_softmax_plain`.

The row sum runs in one fixed order in both: lane l of a 32-lane warp
adds columns l, l+32, l+64, ... in turn, then five xor-butterfly steps
(16, 8, 4, 2, 1) combine the lanes. `cordic_softmax_plain` repeats that
order with elementwise adds, so kernel and plain version agree bit for
bit, and `cordic_softmax_reference` (the plain backend's op) runs the
plain version on any device. The reference sums in XLA's order instead,
so against it the sum may move by an ulp and a probability by one LV
step (2^-lv), and by one step of the FxP output grid after the snap.

The reference pads each row to a multiple of 128 columns with -1e30; each
padded column adds hr_exp(-87) ~ 1.6e-38 to a row sum of at least ~1 (the
max column contributes e^0), far below the sum's last bit. This port
leaves the padding out.

Replaces src/repro/kernels/cordic_softmax/cordic_softmax.py::
cordic_softmax_pallas.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.activation import softmax_lv_stages
from ...core.cordic import extended_exp_float, lv_divide_float
from ...core.fxp import FORMATS, fake_quant
from ..build import cordic_params, library
from ..cordic_af.cordic_af import snap_args, stages

__all__ = ["cordic_softmax", "cordic_softmax_plain", "cordic_softmax_reference",
           "warp_row_sum"]

_LANES = 32
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"cordic_softmax_op": ([_P, _P, _P] + [_I] * 6
                                     + [_F, _F, _P, _P], ctypes.c_int)}


def warp_row_sum(e: torch.Tensor) -> torch.Tensor:
    """Row sums of e [M, N] -> [M, 1] in the kernel's order: per-lane
    sequential partial sums over the columns l, l+32, ..., then the
    xor-butterfly over the 32 lanes."""
    m, n = e.shape
    pad = (-n) % _LANES
    if pad:     # adding an exact 0.0 leaves a partial sum unchanged
        e = torch.nn.functional.pad(e, (0, pad))
    chunks = e.reshape(m, -1, _LANES)
    acc = torch.zeros((m, _LANES), dtype=e.dtype, device=e.device)
    for c in range(chunks.shape[1]):
        acc = acc + chunks[:, c]
    lane = torch.arange(_LANES, device=e.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    return acc[:, :1]


def cordic_softmax_plain(x: torch.Tensor, hr_stages: int = 4,
                         lv_stages: int = 5) -> torch.Tensor:
    """The kernel's row softmax of f32 x [M, N] in plain PyTorch."""
    m = x.amax(dim=-1, keepdim=True)
    e = extended_exp_float(x - m, hr_stages)
    return lv_divide_float(e, warp_row_sum(e).expand_as(e), lv_stages)


def _stages(x: torch.Tensor, precision: Optional[str],
            hr_stages: Optional[int], lv_stages: Optional[int]):
    hr, _ = stages(precision, hr_stages, None)
    lv = (lv_stages if lv_stages is not None
          else softmax_lv_stages(x.shape[-1], precision))
    return hr, lv


def _kernel(x: torch.Tensor, precision: Optional[str], hr: int,
            lv: int) -> torch.Tensor:
    """One launch of the whole op over the CUDA tensor `x` (rows along the
    last axis), same shape and dtype."""
    slots, dtype, snap, qmin, qmax = snap_args(x, precision)
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.shape[-1]
    err = library("cordic_softmax", _SIGNATURES).cordic_softmax_op(
        x.data_ptr(), out.data_ptr(), slots.data_ptr(), slots.numel(),
        x.numel() // n, n, dtype, lv, snap, qmin, qmax,
        ctypes.byref(cordic_params(hr)),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cordic_softmax launch failed: CUDA error {err}")
    cordic_softmax.launches += 1
    return out


def _op(x: torch.Tensor, precision: Optional[str], hr_stages: Optional[int],
        lv_stages: Optional[int], rows_fn) -> torch.Tensor:
    """The reference op's plumbing around `rows_fn(rows [M, N], hr, lv)`:
    stages, the f32 fake-quant in and out, the cast back."""
    hr, lv = _stages(x, precision, hr_stages, lv_stages)
    xf = x.float()
    if precision is not None:
        xf = fake_quant(xf, FORMATS[precision])
    out = rows_fn(xf.reshape(-1, x.shape[-1]), hr, lv).reshape(x.shape)
    if precision is not None:
        out = fake_quant(out, FORMATS[precision])
    return out.to(x.dtype)


def cordic_softmax(x: torch.Tensor, precision: Optional[str] = None,
                   hr_stages: Optional[int] = None,
                   lv_stages: Optional[int] = None) -> torch.Tensor:
    """Softmax over the last axis on the Flex-PE datapath, in x.dtype. A
    CUDA tensor takes one launch of the op's kernel; a CPU tensor runs the
    plain op."""
    if x.device.type == "cpu":
        return _op(x, precision, hr_stages, lv_stages, cordic_softmax_plain)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _kernel(x, precision, *_stages(x, precision, hr_stages,
                                          lv_stages))


cordic_softmax.launches = 0


def cordic_softmax_reference(x: torch.Tensor, precision: Optional[str] = None,
                             hr_stages: Optional[int] = None,
                             lv_stages: Optional[int] = None) -> torch.Tensor:
    """`cordic_softmax` with the plain version on any device: the plain
    backend's op, bit-equal to the kernels backend's."""
    return _op(x, precision, hr_stages, lv_stages, cordic_softmax_plain)
