"""Unified CORDIC engine (paper §II) — the float-structural HR exp and LV
divide that the serving path uses.

  * Hyperbolic Rotational (HR): (X, Y, Z=z) -> (cosh z, sinh z); exp = X+Y
  * Linear Vectoring      (LV): (X=den, Y=num, Z=0) -> Z = num/den

Constants (`1/ln2`, `ln2`, `atanh(2^-i)`, `1/gain`) are Python doubles
rounded once to f32 by the op, and the shift-add products by ±2^-i are
exact, so these functions match the reference package's bit for bit on
the same f32 inputs. The CUDA kernels' device functions
(`csrc/cordic.cuh`) take the same f32 constants from `device_constants`.

Stage counts default to the paper's Pareto points (§II-E):
  FxP4: 4/4/4,  FxP8: 4/5/5,  FxP16: 4/5/5,  FxP32: 8/10/9  (HR/LV/LR).
The bit-accurate `*_fxp` emulators are not part of this package yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PARETO_STAGES", "hyperbolic_gain", "hr_coshsinh_float",
           "exp_float", "exp2_int", "extended_exp_float", "lv_divide_float",
           "device_constants"]

# Paper Pareto points: bits -> (hr_stages, lv_stages, lr_stages)
PARETO_STAGES: dict[int, tuple[int, int, int]] = {
    4: (4, 4, 4),
    8: (4, 5, 5),
    12: (4, 5, 5),
    16: (4, 5, 5),
    24: (8, 10, 9),
    32: (8, 10, 9),
}

_HYPERBOLIC_REPEATS = (4, 13, 40)
_LN2 = math.log(2.0)


def _hr_schedule(stages: int, repeat_iters: bool) -> list[int]:
    """Iteration indices for HR mode (i >= 1; optional classic repeats)."""
    idx, i = [], 1
    while len(idx) < stages:
        idx.append(i)
        if repeat_iters and i in _HYPERBOLIC_REPEATS and len(idx) < stages:
            idx.append(i)
        i += 1
    return idx


def hyperbolic_gain(stages: int, repeat_iters: bool = False) -> float:
    """K_h = prod sqrt(1 - 2^-2i) over the HR schedule."""
    g = 1.0
    for i in _hr_schedule(stages, repeat_iters):
        g *= math.sqrt(1.0 - 2.0 ** (-2 * i))
    return g


def hr_coshsinh_float(z: torch.Tensor, stages: int,
                      repeat_iters: bool = False):
    """HR mode: returns (cosh z, sinh z) approximations; converges for
    |z| <= 1.1182 (paper §II-D)."""
    k = hyperbolic_gain(stages, repeat_iters)
    x = torch.full_like(z, 1.0 / k)
    y = torch.zeros_like(z)
    for i in _hr_schedule(stages, repeat_iters):
        e = math.atanh(2.0 ** (-i))
        d = torch.where(z >= 0, 1.0, -1.0).to(z.dtype)
        x, y = x + d * y * (2.0 ** (-i)), y + d * x * (2.0 ** (-i))
        z = z - d * e
    return x, y


def exp_float(z: torch.Tensor, stages: int,
              repeat_iters: bool = False) -> torch.Tensor:
    """e^z = cosh z + sinh z (paper Eq. 1), |z| <= 1.1182."""
    c, s = hr_coshsinh_float(z, stages, repeat_iters)
    return c + s


def exp2_int(k: torch.Tensor) -> torch.Tensor:
    """Exact 2^k for integer-valued f32 k by building the f32 exponent
    field (the barrel-shift analogue)."""
    ki = torch.clamp(k, -126.0, 127.0).to(torch.int32)
    return ((ki + 127) << 23).view(torch.float32)


def extended_exp_float(z: torch.Tensor, stages: int,
                       repeat_iters: bool = True) -> torch.Tensor:
    """Range-extended exp: z = k*ln2 + r, e^z = 2^k * e^r (r in
    [-ln2/2, ln2/2], inside the HR convergence range)."""
    z = torch.clamp(z, -87.0, 88.0)
    k = torch.floor(z * (1.0 / _LN2) + 0.5)
    r = z - k * _LN2
    return exp_float(r, stages, repeat_iters) * exp2_int(k)


def lv_divide_float(num: torch.Tensor, den: torch.Tensor,
                    stages: int) -> torch.Tensor:
    """LV mode: num/den via shift-add. Requires |num| <= |den|."""
    x, y = den, num
    zq = torch.zeros_like(num)
    for i in range(1, stages + 1):
        d = -torch.sign(x * y)
        d = torch.where(d == 0, 1.0, d).to(num.dtype)
        y = y + d * x * (2.0 ** (-i))
        zq = zq - d * (2.0 ** (-i))
    return zq


def device_constants(hr_stages: int, repeat_iters: bool = True) -> dict:
    """The f32 constants the CUDA device functions use, rounded here once
    from Python doubles exactly as the float path rounds them:
    {inv_ln2, ln2, inv_gain, shifts (HR schedule), atanh (per stage)}."""
    sched = _hr_schedule(hr_stages, repeat_iters)
    f32 = np.float32
    return {"inv_ln2": f32(1.0 / _LN2), "ln2": f32(_LN2),
            "inv_gain": f32(1.0 / hyperbolic_gain(hr_stages, repeat_iters)),
            "shifts": sched,
            "atanh": [f32(math.atanh(2.0 ** (-i))) for i in sched]}
