"""fxp_gemm_fused: integer code GEMM with the fused dequant (+ CORDIC AF)
epilogue — the Flex-PE MAC -> AF pipeline in one launch.

    out[M, N] = AF(float(x_codes[M, K] @ w_codes[K, N]) * scale[N])

`fxp_gemm_fused` is the wrapper: for CUDA tensors it launches the
hand-written Hopper kernel (`csrc/fxp_gemm.cu`) or raises; only for CPU
tensors does it run `fxp_gemm_fused_plain`, the plain PyTorch version of
the same arithmetic. The int32 product is exact in both (integer sums do
not depend on order), and the epilogue runs the same f32 operations, so
the two agree bit for bit. `fxp_gemm_fused_batched` runs one such product
per MoE expert ([E, M, K] @ [E, K, N]) in one launch of the same kernel;
its plain version is the loop over experts.

Replaces src/repro/kernels/fxp_gemm/fxp_gemm.py::fxp_gemm_fused_pallas
for int8 codes (FxP <= 8). Packed FxP4 nibbles and >8-bit codes are still
to be ported (ROADMAP.md queue 2, item 7).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..build import cordic_params, library
from ..cordic_af.cordic_af import AF_CODE, KERNEL_AFS, cordic_af_plain

__all__ = ["FUSED_AFS", "fxp_gemm_fused", "fxp_gemm_fused_plain",
           "fxp_gemm_fused_batched", "fxp_gemm_fused_batched_plain",
           "int_matmul", "k_split"]

#: AFs the fused epilogue supports (the Flex-PE Sel_AF set minus softmax).
FUSED_AFS = KERNEL_AFS

_SMS = 132            # H100 SXM streaming multiprocessors
_BLOCK_N = 128        # kBlockN in csrc/fxp_gemm.cu
_MAX_KPS = 1024       # kMaxKSplit in csrc/fxp_gemm.cu
_PLAIN_COLS = 16384   # column chunk of the plain product (bounds its f64)


def int_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of integer codes in plain PyTorch. The f64
    product is exact while every partial sum stays below 2^53 (K * 127^2
    for int8 codes); columns go in chunks to bound the f64 temporaries."""
    xf = x_codes.to(torch.float64)
    cols = [xf @ w_codes[:, j:j + _PLAIN_COLS].to(torch.float64)
            for j in range(0, w_codes.shape[1], _PLAIN_COLS)]
    return torch.cat(cols, dim=1).to(torch.int32)


def fxp_gemm_fused_plain(x_codes: torch.Tensor, w_codes: torch.Tensor,
                         scale: torch.Tensor, af: Optional[str] = None,
                         hr_stages: int = 4, lv_stages: int = 5
                         ) -> torch.Tensor:
    """Plain version: int32 [M, N] product, times scale [N] in f32, then
    the optional CORDIC AF. Any integer code dtype."""
    out = int_matmul(x_codes, w_codes).float() * scale.reshape(1, -1)
    if af is not None:
        out = cordic_af_plain(out, af, hr_stages, lv_stages)
    return out


def fxp_gemm_fused_batched_plain(x_codes: torch.Tensor,
                                 w_codes: torch.Tensor, scale: torch.Tensor,
                                 af: Optional[str] = None, hr_stages: int = 4,
                                 lv_stages: int = 5) -> torch.Tensor:
    """Plain version of the batched entry: `fxp_gemm_fused_plain` on each
    expert's [M, K] @ [K, N] with its [N] scale -> f32 [E, M, N]."""
    return torch.stack([
        fxp_gemm_fused_plain(x_codes[e], w_codes[e], scale[e], af, hr_stages,
                             lv_stages) for e in range(x_codes.shape[0])])


def k_split(m: int, k: int, n: int, experts: int = 1) -> int:
    """K rows per block: enough blocks to fill the card twice over at
    decode shapes, at most `_MAX_KPS` rows (the staged A slice), a
    multiple of 32 (four rows per warp step, eight warps)."""
    tiles = -(-n // _BLOCK_N) * -(-m // 16) * experts
    splits = max(-(-k // _MAX_KPS), min(-(-4 * _SMS // tiles), -(-k // 128)))
    kps = -(-k // splits)
    return min(_MAX_KPS, -(-kps // 32) * 32)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fxp_gemm_fused": ([_P] * 6 + [_I] * 7 + [_P, _P],
                                  ctypes.c_int),
               "fxp_gemm_fused_batched": ([_P] * 6 + [_I] * 8 + [_P, _P],
                                          ctypes.c_int)}


def _launch(x_codes, w_codes, scale, af, hr_stages, lv_stages, experts):
    """One launch over x [E, M, K], w [E, K, N], scale [E, N] (CUDA, int8
    codes, checked by the callers) -> f32 [E, M, N]: the expert-batched
    kernel, or for E = 1 without `experts` the single-matrix one."""
    e, m, k = x_codes.shape
    n = w_codes.shape[2]
    for t in (w_codes, scale):
        if t.device != x_codes.device:
            raise ValueError("operands on different devices")
    x_codes = x_codes.contiguous()
    w_codes = w_codes.contiguous()
    scale = scale.reshape(e, n).to(torch.float32).contiguous()
    out = torch.empty((e, m, n), dtype=torch.float32, device=x_codes.device)
    kps = k_split(m, k, n, e)
    m_tiles = 1 if m <= 8 else -(-m // 16)     # MT = 4, 8 or 16 rows
    tiles = -(-n // _BLOCK_N) * m_tiles * e
    # with split K: an int32 workspace [E, M, N] and one semaphore per
    # tile, zeroed; one K slice per tile reads neither
    ws_len = e * m * n + tiles if kps < k else 1
    ws = torch.zeros(ws_len, dtype=torch.int32, device=x_codes.device)
    vec = int(n % 4 == 0 and w_codes.data_ptr() % 4 == 0)
    lib = library("fxp_gemm", _SIGNATURES)
    ptrs = (x_codes.data_ptr(), w_codes.data_ptr(), scale.data_ptr(),
            out.data_ptr(), ws.data_ptr(),
            ws[ws_len - tiles:].data_ptr() if kps < k else ws.data_ptr())
    tail = (m, k, n, kps, vec, AF_CODE[af], lv_stages,
            ctypes.byref(cordic_params(hr_stages)),
            torch.cuda.current_stream(x_codes.device).cuda_stream)
    err = (lib.fxp_gemm_fused_batched(*ptrs, e, *tail) if experts
           else lib.fxp_gemm_fused(*ptrs, *tail))
    if err != 0:
        raise RuntimeError(f"fxp_gemm_fused launch failed: CUDA error {err}")
    fxp_gemm_fused.launches += 1
    return out


def _check_kernel_operands(x_codes, w_codes):
    if x_codes.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_codes.device}")
    if x_codes.dtype != torch.int8 or w_codes.dtype != torch.int8:
        raise NotImplementedError(
            "fxp_gemm_fused kernel takes int8 codes only; packed FxP4 and "
            ">8-bit codes are ROADMAP.md queue 2, item 7")


def fxp_gemm_fused(x_codes: torch.Tensor, w_codes: torch.Tensor,
                   scale: torch.Tensor, af: Optional[str] = None,
                   hr_stages: int = 4, lv_stages: int = 5) -> torch.Tensor:
    """x_codes int8 [M, K] @ w_codes int8 [K, N] -> f32 [M, N] =
    AF(acc * scale[N]). CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    if af is not None and af not in FUSED_AFS:
        raise ValueError(f"unsupported fused af {af!r}")
    if x_codes.device.type == "cpu":
        return fxp_gemm_fused_plain(x_codes, w_codes, scale, af, hr_stages,
                                    lv_stages)
    _check_kernel_operands(x_codes, w_codes)
    m, k = x_codes.shape
    k2, n = w_codes.shape
    if k2 != k or scale.numel() != n:
        raise ValueError(f"shape mismatch: x {tuple(x_codes.shape)}, "
                         f"w {tuple(w_codes.shape)}, scale {scale.numel()}")
    return _launch(x_codes[None], w_codes[None], scale, af, hr_stages,
                   lv_stages, experts=False)[0]


fxp_gemm_fused.launches = 0


def fxp_gemm_fused_batched(x_codes: torch.Tensor, w_codes: torch.Tensor,
                           scale: torch.Tensor, af: Optional[str] = None,
                           hr_stages: int = 4, lv_stages: int = 5
                           ) -> torch.Tensor:
    """Per expert e: x_codes int8 [E, M, K][e] @ w_codes int8 [E, K, N][e]
    -> f32 [E, M, N], times scale [E, N] (or [E, 1, N]), then the optional
    AF. CUDA tensors launch the kernel once for all experts (counted on
    `fxp_gemm_fused.launches`); CPU tensors run the plain loop."""
    if af is not None and af not in FUSED_AFS:
        raise ValueError(f"unsupported fused af {af!r}")
    e, m, k = x_codes.shape
    if (w_codes.dim() != 3 or w_codes.shape[:2] != (e, k)
            or scale.numel() != e * w_codes.shape[2]):
        raise ValueError(f"shape mismatch: x {tuple(x_codes.shape)}, "
                         f"w {tuple(w_codes.shape)}, scale "
                         f"{tuple(scale.shape)}")
    scale = scale.reshape(e, -1)
    if x_codes.device.type == "cpu":
        return fxp_gemm_fused_batched_plain(x_codes, w_codes, scale, af,
                                            hr_stages, lv_stages)
    _check_kernel_operands(x_codes, w_codes)
    return _launch(x_codes, w_codes, scale, af, hr_stages, lv_stages,
                   experts=True)
