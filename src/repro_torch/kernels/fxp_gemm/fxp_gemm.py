"""fxp_gemm_fused: integer code GEMM with the fused dequant (+ CORDIC AF)
epilogue — the Flex-PE MAC -> AF pipeline in one launch.

    out[M, N] = AF(float(x_codes[M, K] @ w_codes[K, N]) * scale[N])

`fxp_gemm_fused` is the wrapper: for CUDA tensors it launches the
hand-written Hopper kernel (`csrc/fxp_gemm.cu`) or raises; only for CPU
tensors does it run `fxp_gemm_fused_plain`, the plain PyTorch version of
the same arithmetic. Both take the exact integer sum of the code
products (integer sums do not depend on order), round it once to f32 and
run the same f32 epilogue, so the two agree bit for bit.
`fxp_gemm_fused_batched` runs one such product per MoE expert
([E, M, K] @ [E, K, N]) in one launch of the same kernel; its plain
version is the loop over experts.

Modes, each its own kernel instantiation (`launches_by_mode` counts them):
  * int8      — int8 codes (FxP <= 8), an int32 accumulator;
  * packed    — `packed=True`: the weight is packed FxP4, int8 bytes
                [K, NB] (the int32 words of `core.simd.pack` seen as
                bytes), byte j holding elements 2j (low nibble) and 2j+1
                (high), sign-extended; N = scale.numel() <= 2 NB;
  * wide      — int16 codes (FxP12/16): each code splits into a signed
                high byte and an unsigned low byte, four int8 tensor-core
                products of the byte planes combine exactly in int64, and
                the exact sum rounds once to f32 (`byte_plane_matmul` is
                that arithmetic in plain PyTorch); exact while
                K * 2^30 < 2^53;
  * batched and batched_packed — the expert banks, int8 or packed.
Where each runs: the int8 and int8 bank modes walk B with `__dp4a` on the
CUDA cores (`fxp_gemm_fused_kernel`); the packed, packed bank and wide
modes and the raw int8, int16 and packed code GEMMs run on the
tensor-core core (`fxp_gemm_tc_kernel`): `mma.sync` tiles fed by
asynchronous copies, the nibbles of packed weights turned into int8
fragments in registers as 16 times their codes, the factor shifted off
the exact int32 sum (csrc/fxp_gemm.cu says what bounds each and what its
design does about it). At decode every one of them is bound by reading the
weight once.
The reference's Pallas kernel sums codes wider than 8 bits in f32 in
XLA's order (int32 only under its `wide_exact` bound K * qmax^2 < 2^31,
where this port equals it bit for bit); the port's exact sum is within
one f32 rounding per step of the reference's.

`fxp_gemm_codes` and `fxp4_gemm_packed` are the raw code GEMMs: the exact
int32 product with no epilogue, on int8 or wider codes (the caller owns the
bound K * qmax^2 < 2^31 past 8 bits), or on packed FxP4 weights.

Replaces src/repro/kernels/fxp_gemm/fxp_gemm.py::fxp_gemm_fused_pallas
(every mode), ::fxp_gemm_pallas and ::fxp4_gemm_packed_pallas.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..build import cordic_params, library
from ..cordic_af.cordic_af import AF_CODE, KERNEL_AFS, cordic_af_plain

__all__ = ["FUSED_AFS", "fxp_gemm_fused", "fxp_gemm_fused_plain",
           "fxp_gemm_fused_batched", "fxp_gemm_fused_batched_plain",
           "fxp_gemm_codes", "fxp_gemm_codes_plain", "fxp4_gemm_packed",
           "fxp4_gemm_packed_plain", "unpack_nibbles", "int_matmul",
           "exact_matmul", "byte_plane_matmul", "k_split", "GEMM_MODES",
           "reset_launches"]

#: AFs the fused epilogue supports (the Flex-PE Sel_AF set minus softmax).
FUSED_AFS = KERNEL_AFS

_SMS = 132            # H100 SXM streaming multiprocessors
_BLOCK_N = 128        # kBlockN in csrc/fxp_gemm.cu (the __dp4a walk)
_MAX_KPS = 1024       # kMaxKSplit in csrc/fxp_gemm.cu
_TC_ROW_BYTES = 128   # tc::kRowBytes in csrc/fxp_gemm.cu (the tensor-core
                      # core): a block's columns, 128 int8, 64 int16 or 256
                      # packed FxP4 codes
_TC_BLOCK_K = 128     # tc::kBK: k rows per stage
_TC_BLOCKS = 2 * _SMS  # blocks of the core resident at once (two per SM)
_MAX_KPS_WIDE = 32768  # tc::kMaxKSplitWide: 2 * 128 * 255 * 32768 < 2^31
_PLAIN_COLS = 16384   # column chunk of the plain product (bounds its f64)

#: the fused GEMM's kernel modes, counted per launch
GEMM_MODES = ("int8", "packed", "wide", "batched", "batched_packed")


def exact_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor
                 ) -> torch.Tensor:
    """The integer product of codes as f64 [M, N] in plain PyTorch: every
    product and partial sum is an integer below 2^53 (K * 2^30 for int16
    codes), so it is exact in any order. Columns go in chunks to bound
    the f64 temporaries."""
    xf = x_codes.to(torch.float64)
    cols = [xf @ w_codes[:, j:j + _PLAIN_COLS].to(torch.float64)
            for j in range(0, w_codes.shape[1], _PLAIN_COLS)]
    return torch.cat(cols, dim=1)


def int_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of integer codes (K * qmax^2 < 2^31)."""
    return exact_matmul(x_codes, w_codes).to(torch.int32)


def byte_plane_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor
                      ) -> torch.Tensor:
    """The tensor-core core's arithmetic on codes of up to 16 bits, in
    plain PyTorch -> int64 [M, N]: each code c splits into a signed high
    byte h = c >> 8 and an unsigned low byte l = c & 255; the products hh,
    hl + lh (one accumulator) and ll are int32 sums, combined exactly in
    int64 as (hh << 16) + ((hl + lh) << 8) + ll. K goes in slices of the
    cap `_MAX_KPS_WIDE`, the most rows any int32 accumulator of the kernel
    sums (its blocks and warps sum smaller slices; exact integer sums do
    not depend on the cut). For the tests, on CPU tensors (CUDA has no
    int64 product): no path calls it."""
    x = x_codes.to(torch.int64)
    w = w_codes.to(torch.int64)
    xh, xl, wh, wl = x >> 8, x & 255, w >> 8, w & 255

    def acc32(v):                    # an int32 accumulator's sum
        return v.to(torch.int32).to(torch.int64)
    total = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64)
    for k0 in range(0, x.shape[1], _MAX_KPS_WIDE):
        ks = slice(k0, k0 + _MAX_KPS_WIDE)
        a, b, c, d = xh[:, ks], xl[:, ks], wh[ks], wl[ks]
        total += ((acc32(a @ c) << 16) + (acc32(a @ d + b @ c) << 8)
                  + acc32(b @ d))
    return total


def unpack_nibbles(w_bytes: torch.Tensor, n: Optional[int] = None
                   ) -> torch.Tensor:
    """Packed int8 bytes [K, NB] -> int8 codes [K, 2 NB] (the first `n`
    columns when given): byte j's low nibble is element 2j, its high
    nibble element 2j+1, each sign-extended."""
    b = w_bytes.to(torch.int32)
    lo, hi = b & 0xF, (b >> 4) & 0xF
    codes = torch.stack([lo, hi], dim=-1).reshape(b.shape[0], -1)
    codes = torch.where(codes >= 8, codes - 16, codes).to(torch.int8)
    return codes if n is None else codes[:, :n]


def fxp_gemm_fused_plain(x_codes: torch.Tensor, w_codes: torch.Tensor,
                         scale: torch.Tensor, af: Optional[str] = None,
                         hr_stages: int = 4, lv_stages: int = 5,
                         packed: bool = False) -> torch.Tensor:
    """Plain version: the exact integer [M, N] product rounded once to
    f32, times scale [N] in f32, then the optional CORDIC AF. Codes of up
    to 16 bits; `packed` weights are unpacked first."""
    if packed:
        w_codes = unpack_nibbles(w_codes, scale.numel())
    out = exact_matmul(x_codes, w_codes).float() * scale.reshape(1, -1)
    if af is not None:
        out = cordic_af_plain(out, af, hr_stages, lv_stages)
    return out


def fxp_gemm_fused_batched_plain(x_codes: torch.Tensor,
                                 w_codes: torch.Tensor, scale: torch.Tensor,
                                 af: Optional[str] = None, hr_stages: int = 4,
                                 lv_stages: int = 5, packed: bool = False
                                 ) -> torch.Tensor:
    """Plain version of the batched entry: `fxp_gemm_fused_plain` on each
    expert's [M, K] @ [K, N] (or packed bytes [K, NB]) with its [N] scale
    -> f32 [E, M, N]."""
    scale = scale.reshape(x_codes.shape[0], -1)
    return torch.stack([
        fxp_gemm_fused_plain(x_codes[e], w_codes[e], scale[e], af, hr_stages,
                             lv_stages, packed)
        for e in range(x_codes.shape[0])])


def _tiles(m: int, packed: bool = False, core=None) -> tuple[int, int]:
    """(columns per block, row tiles) of a kernel's grid. The tensor-core
    core (`core` the codes' dtype, int8 or int16; packed weights always
    run there): a stage row of 128 bytes of columns (128 int8, 64 int16
    or 256 packed FxP4 codes); tiles of 8, 16 or 32 rows (16 at most for
    int16 codes). The __dp4a walk (int8 codes): 128 columns; one tile up
    to 8 rows, else tiles of 16 rows."""
    if core is not None or packed:
        wide = core == torch.int16
        rows = 8 if m <= 8 else 16 if m <= 16 or wide else 32
        cols = (2 if packed else 1) * _TC_ROW_BYTES // (2 if wide else 1)
        return cols, -(-m // rows)
    return _BLOCK_N, 1 if m <= 8 else -(-m // 16)


def k_split(m: int, k: int, n: int, experts: int = 1,
            packed: bool = False, core=None) -> int:
    """K rows per block. The tensor-core core (`core` and `packed` as for
    `_tiles`; `experts` counts a bank's tiles): as many blocks as fit two
    to an SM (`_TC_BLOCKS`; a few more would wait for a second wave; one
    to an SM for packed weights' 32-row tiles, whose 256 threads hold
    over half an SM's registers), at least 256 rows each, at most
    `_MAX_KPS_WIDE`, a multiple of a stage's 128 rows.
    The __dp4a walk: enough blocks to fill the card four times over at
    decode shapes, at most the staged A slice's rows (`_MAX_KPS`), a
    multiple of 32 (four rows per warp step, eight warps)."""
    block_n, m_tiles = _tiles(m, packed, core)
    tiles = -(-n // block_n) * m_tiles * experts
    if core is not None or packed:
        resident = _SMS if packed and m > 16 else _TC_BLOCKS
        splits = max(-(-k // _MAX_KPS_WIDE),
                     min(max(1, resident // tiles), -(-k // 256)))
        kps = -(-k // splits)
        return -(-kps // _TC_BLOCK_K) * _TC_BLOCK_K
    splits = max(-(-k // _MAX_KPS), min(-(-4 * _SMS // tiles), -(-k // 128)))
    kps = -(-k // splits)
    return min(_MAX_KPS, -(-kps // 32) * 32)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fxp_gemm_fused": ([_P] * 6 + [_I] * 7 + [_P, _P],
                                  ctypes.c_int),
               "fxp_gemm_fused_batched": ([_P] * 6 + [_I] * 8 + [_P, _P],
                                          ctypes.c_int),
               "fxp_gemm_fused_packed": ([_P] * 6 + [_I] * 8 + [_P, _P],
                                         ctypes.c_int),
               "fxp_gemm_fused_batched_packed": ([_P] * 6 + [_I] * 9
                                                 + [_P, _P], ctypes.c_int),
               "fxp_gemm_fused_wide": ([_P] * 6 + [_I] * 7 + [_P, _P],
                                       ctypes.c_int),
               "fxp_gemm_codes_int8": ([_P] * 5 + [_I] * 7 + [_P],
                                       ctypes.c_int),
               "fxp_gemm_codes_int16": ([_P] * 5 + [_I] * 5 + [_P],
                                        ctypes.c_int),
               "fxp_gemm_codes_int32": ([_P] * 3 + [_I] * 3 + [_P],
                                        ctypes.c_int)}


def _workspace(x_codes, e, m, k, n, packed, core=None):
    """(kps, workspace, semaphore pointer): with split K a workspace
    [E, M, N] (int32; int64 for int16 codes on the tensor-core core) and
    one int32 semaphore per tile, zeroed; one K slice per tile reads
    neither."""
    kps = k_split(m, k, n, e, packed, core)
    if core is not None or packed:
        assert kps <= _MAX_KPS_WIDE, "a block's int32 plane sums would overflow"
    block_n, m_tiles = _tiles(m, packed, core)
    tiles = -(-n // block_n) * m_tiles * e
    words = 2 if core == torch.int16 else 1   # int32 words per entry
    ws_len = words * e * m * n + tiles if kps < k else 1
    ws = torch.zeros(ws_len, dtype=torch.int32, device=x_codes.device)
    return kps, ws, (ws[ws_len - tiles:] if kps < k else ws).data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(mode):
    fxp_gemm_fused.launches += 1
    fxp_gemm_fused.launches_by_mode[mode] += 1


def _launch(x_codes, w_codes, scale, af, hr_stages, lv_stages, experts,
            packed=False):
    """One launch over x [E, M, K], w [E, K, N] (or packed bytes [E, K,
    NB]), scale [E, N] (CUDA, int8 codes, checked by the callers) -> f32
    [E, M, N]: the expert-batched kernel, or for E = 1 without `experts`
    the single-matrix one; int8 codes on the __dp4a walk, packed weights
    on the tensor-core core."""
    e, m, k = x_codes.shape
    n = scale.numel() // e
    x_codes = x_codes.contiguous()
    w_codes = w_codes.contiguous()
    scale = scale.reshape(e, n).to(torch.float32).contiguous()
    out = torch.empty((e, m, n), dtype=torch.float32, device=x_codes.device)
    kps, ws, sem = _workspace(x_codes, e, m, k, n, packed)
    ldb = w_codes.shape[2]
    vec = (_tc_vec(x_codes, w_codes) if packed
           else int(ldb % 4 == 0 and w_codes.data_ptr() % 4 == 0))
    lib = library("fxp_gemm", _SIGNATURES)
    ptrs = (x_codes.data_ptr(), w_codes.data_ptr(), scale.data_ptr(),
            out.data_ptr(), ws.data_ptr(), sem)
    tail = (kps, vec, AF_CODE[af], lv_stages,
            ctypes.byref(cordic_params(hr_stages)), _stream(x_codes))
    if experts and packed:
        err = lib.fxp_gemm_fused_batched_packed(*ptrs, e, m, k, n, ldb,
                                                *tail)
        mode = "batched_packed"
    elif experts:
        err = lib.fxp_gemm_fused_batched(*ptrs, e, m, k, n, *tail)
        mode = "batched"
    elif packed:
        err = lib.fxp_gemm_fused_packed(*ptrs, m, k, n, ldb, *tail)
        mode = "packed"
    else:
        err = lib.fxp_gemm_fused(*ptrs, m, k, n, *tail)
        mode = "int8"
    if err != 0:
        raise RuntimeError(f"fxp_gemm_fused launch failed: CUDA error {err}")
    _count(mode)
    return out


def _tc_vec(x_codes, w_codes):
    """The tensor-core core's `vec` bits: 1 when the weight's rows, 2 when
    the activation's rows are 16-byte aligned (copied in 16-byte chunks;
    otherwise code by code), for operands [..., K] and [..., K, N] (or
    packed bytes [..., K, NB]) of one dtype."""
    e = x_codes.element_size()
    return (int(w_codes.shape[-1] * e % 16 == 0
                and w_codes.data_ptr() % 16 == 0)
            | 2 * int(x_codes.shape[-1] * e % 16 == 0
                      and x_codes.data_ptr() % 16 == 0))


def _launch_wide(x_codes, w_codes, scale, af, hr_stages, lv_stages):
    """One launch of the tensor-core core over int16 x [M, K], w [K, N]
    and scale [N] (CUDA, checked by the caller) -> f32 [M, N]."""
    m, k = x_codes.shape
    n = scale.numel()
    x_codes = x_codes.contiguous()
    w_codes = w_codes.contiguous()
    scale = scale.reshape(n).to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x_codes.device)
    kps, ws, sem = _workspace(x_codes, 1, m, k, n, False, torch.int16)
    vec = _tc_vec(x_codes, w_codes)
    err = library("fxp_gemm", _SIGNATURES).fxp_gemm_fused_wide(
        x_codes.data_ptr(), w_codes.data_ptr(), scale.data_ptr(),
        out.data_ptr(), ws.data_ptr(), sem, m, k, n, kps, vec, AF_CODE[af],
        lv_stages, ctypes.byref(cordic_params(hr_stages)), _stream(x_codes))
    if err != 0:
        raise RuntimeError(f"fxp_gemm_fused wide launch failed: CUDA error "
                           f"{err}")
    _count("wide")
    return out


_KERNEL_CODES = (torch.int8, torch.int16)


def _check_kernel_operands(x_codes, w_codes, scale):
    if x_codes.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_codes.device}")
    for t in (w_codes, scale):
        if t.device != x_codes.device:
            raise ValueError("operands on different devices")
    if (x_codes.dtype not in _KERNEL_CODES
            or w_codes.dtype not in _KERNEL_CODES):
        raise NotImplementedError(
            f"fxp_gemm_fused kernel takes int8 or int16 codes (FxP <= 16), "
            f"not {x_codes.dtype} and {w_codes.dtype}")


def _check_packed(w_bytes, n):
    if w_bytes.dim() != 2 or not 0 < n <= 2 * w_bytes.shape[1]:
        raise ValueError(f"packed weight {tuple(w_bytes.shape)} holds at "
                         f"most {2 * w_bytes.shape[-1]} columns, not {n}")


def fxp_gemm_fused(x_codes: torch.Tensor, w_codes: torch.Tensor,
                   scale: torch.Tensor, af: Optional[str] = None,
                   hr_stages: int = 4, lv_stages: int = 5,
                   packed: bool = False) -> torch.Tensor:
    """x_codes [M, K] @ w_codes [K, N] -> f32 [M, N] = AF(acc * scale[N]),
    on int8 codes, or int16 codes (the wide mode; an int8 operand beside
    an int16 one is widened); with `packed`, w_codes is packed FxP4 bytes
    [K, NB] and N = scale.numel(). CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    if af is not None and af not in FUSED_AFS:
        raise ValueError(f"unsupported fused af {af!r}")
    k = x_codes.shape[1]
    n = scale.numel()
    if packed:
        _check_packed(w_codes, n)
    elif w_codes.shape[1] != n:
        raise ValueError(f"shape mismatch: w {tuple(w_codes.shape)}, "
                         f"scale {n}")
    if w_codes.shape[0] != k:
        raise ValueError(f"shape mismatch: x {tuple(x_codes.shape)}, "
                         f"w {tuple(w_codes.shape)}")
    if x_codes.device.type == "cpu":
        return fxp_gemm_fused_plain(x_codes, w_codes, scale, af, hr_stages,
                                    lv_stages, packed)
    _check_kernel_operands(x_codes, w_codes, scale)
    if x_codes.dtype == torch.int16 or w_codes.dtype == torch.int16:
        if packed:
            raise ValueError("packed weights hold FxP4 codes; the activation "
                             "codes must be int8")
        return _launch_wide(x_codes.to(torch.int16), w_codes.to(torch.int16),
                            scale, af, hr_stages, lv_stages)
    return _launch(x_codes[None], w_codes[None], scale, af, hr_stages,
                   lv_stages, experts=False, packed=packed)[0]


def reset_launches():
    """Set `fxp_gemm_fused`'s launch counts (the total and each mode's)
    to 0."""
    fxp_gemm_fused.launches = 0
    fxp_gemm_fused.launches_by_mode = dict.fromkeys(GEMM_MODES, 0)


reset_launches()


def fxp_gemm_fused_batched(x_codes: torch.Tensor, w_codes: torch.Tensor,
                           scale: torch.Tensor, af: Optional[str] = None,
                           hr_stages: int = 4, lv_stages: int = 5,
                           packed: bool = False) -> torch.Tensor:
    """Per expert e: x_codes int8 [E, M, K][e] @ w_codes int8 [E, K, N][e]
    -> f32 [E, M, N], times scale [E, N] (or [E, 1, N]), then the optional
    AF; with `packed`, w_codes is packed FxP4 bytes [E, K, NB] and
    N = scale.numel() / E <= 2 NB. CUDA tensors launch the kernel once for
    all experts (counted on `fxp_gemm_fused.launches`); CPU tensors run
    the plain loop. Banks of >8-bit codes have no batched kernel (the
    dispatch runs them per expert on the wide mode)."""
    if af is not None and af not in FUSED_AFS:
        raise ValueError(f"unsupported fused af {af!r}")
    e, m, k = x_codes.shape
    if w_codes.dim() != 3 or w_codes.shape[:2] != (e, k):
        raise ValueError(f"shape mismatch: x {tuple(x_codes.shape)}, "
                         f"w {tuple(w_codes.shape)}")
    n = scale.numel() // e
    if packed:
        _check_packed(w_codes[0], n)
    elif scale.numel() != e * w_codes.shape[2]:
        raise ValueError(f"shape mismatch: w {tuple(w_codes.shape)}, scale "
                         f"{tuple(scale.shape)}")
    scale = scale.reshape(e, n)
    if x_codes.device.type == "cpu":
        return fxp_gemm_fused_batched_plain(x_codes, w_codes, scale, af,
                                            hr_stages, lv_stages, packed)
    _check_kernel_operands(x_codes, w_codes, scale)
    if x_codes.dtype != torch.int8 or w_codes.dtype != torch.int8:
        raise NotImplementedError(
            "the batched kernel takes int8 codes (or packed FxP4 bytes); "
            "banks of >8-bit codes run per expert on the wide mode")
    return _launch(x_codes, w_codes, scale, af, hr_stages, lv_stages,
                   experts=True, packed=packed)


# ---------------------------------------------------------------------------
# raw code GEMMs: the exact int32 product, no epilogue
# ---------------------------------------------------------------------------

_WIDE = (torch.int8, torch.int16, torch.int32)


def fxp_gemm_codes_plain(x_codes: torch.Tensor, w_codes: torch.Tensor
                         ) -> torch.Tensor:
    """int [M, K] @ int [K, N] -> int32 [M, N] in plain PyTorch."""
    return int_matmul(x_codes, w_codes)


def fxp4_gemm_packed_plain(x_codes: torch.Tensor, w_packed: torch.Tensor
                           ) -> torch.Tensor:
    """int8 [M, K] @ packed FxP4 bytes [K, N/2] -> int32 [M, N]."""
    return int_matmul(x_codes, unpack_nibbles(w_packed))


def _raw_code_gemm(x_codes, w_codes, n, packed=False):
    """One launch of a raw code GEMM over x [M, K] and w [K, N] (or
    packed bytes [K, N/2]) -> int32 [M, N] on the tensor-core core: int8
    and int16 codes, and packed weights."""
    m, k = x_codes.shape
    x_codes, w_codes = x_codes.contiguous(), w_codes.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=x_codes.device)
    core = x_codes.dtype
    kps, ws, sem = _workspace(x_codes, 1, m, k, n, packed, core)
    lib = library("fxp_gemm", _SIGNATURES)
    ptrs = (x_codes.data_ptr(), w_codes.data_ptr(), out.data_ptr(),
            ws.data_ptr(), sem)
    vec = _tc_vec(x_codes, w_codes)
    if core == torch.int16:
        err = lib.fxp_gemm_codes_int16(*ptrs, m, k, n, kps, vec,
                                       _stream(x_codes))
    else:
        err = lib.fxp_gemm_codes_int8(*ptrs, m, k, n, w_codes.shape[1],
                                      int(packed), kps, vec, _stream(x_codes))
    if err != 0:
        raise RuntimeError(f"code GEMM launch failed: CUDA error {err}")
    return out


def _check_raw(x_codes, w_codes, k_w):
    if x_codes.is_floating_point() or w_codes.is_floating_point():
        raise TypeError(f"code GEMM wants integer codes, not "
                        f"{x_codes.dtype} and {w_codes.dtype}")
    if x_codes.dim() != 2 or w_codes.dim() != 2 or k_w != x_codes.shape[1]:
        raise ValueError(f"shape mismatch: x {tuple(x_codes.shape)}, "
                         f"w {tuple(w_codes.shape)}")
    if x_codes.device != w_codes.device:
        raise ValueError("operands on different devices")
    if x_codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x_codes.device}")


def fxp_gemm_codes(x_codes: torch.Tensor, w_codes: torch.Tensor
                   ) -> torch.Tensor:
    """Raw code GEMM: int [M, K] @ int [K, N] -> int32 [M, N], exact
    int32 sums. Both operands take the wider of the two dtypes: int8 and
    int16 codes run on the tensor-core core (int16 as byte planes, the low
    32 bits of the exact sum), int32 codes a plain int32 multiply-add;
    past 8 bits exact while K * qmax^2 < 2^31, which the caller owns.
    CUDA tensors launch a kernel; CPU tensors run the plain version."""
    _check_raw(x_codes, w_codes, w_codes.shape[0])
    if x_codes.device.type == "cpu":
        return fxp_gemm_codes_plain(x_codes, w_codes)
    if x_codes.dtype not in _WIDE or w_codes.dtype not in _WIDE:
        raise NotImplementedError(
            f"code GEMM of {x_codes.dtype} and {w_codes.dtype}: integer "
            "codes of 8, 16 or 32 bits only")
    m, n = x_codes.shape[0], w_codes.shape[1]
    wide = max(x_codes.dtype, w_codes.dtype, key=_WIDE.index)
    xw = x_codes.to(wide).contiguous()
    ww = w_codes.to(wide).contiguous()
    if wide != torch.int32:
        out = _raw_code_gemm(xw, ww, n)
    else:
        out = torch.empty((m, n), dtype=torch.int32, device=x_codes.device)
        err = library("fxp_gemm", _SIGNATURES).fxp_gemm_codes_int32(
            xw.data_ptr(), ww.data_ptr(), out.data_ptr(), m,
            x_codes.shape[1], n, _stream(xw))
        if err != 0:
            raise RuntimeError(f"code GEMM launch failed: CUDA error {err}")
    fxp_gemm_codes.launches += 1
    return out


fxp_gemm_codes.launches = 0


def fxp4_gemm_packed(x_codes: torch.Tensor, w_packed: torch.Tensor
                     ) -> torch.Tensor:
    """Raw code GEMM on packed FxP4 weights: int8 [M, K] @ bytes [K, N/2]
    -> int32 [M, N] (N = 2 x the byte columns; byte j holds columns 2j
    and 2j+1). CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    _check_raw(x_codes, w_packed, w_packed.shape[0])
    if x_codes.device.type == "cpu":
        return fxp4_gemm_packed_plain(x_codes, w_packed)
    if x_codes.dtype != torch.int8 or w_packed.dtype != torch.int8:
        raise NotImplementedError("packed code GEMM takes int8 codes and "
                                  "int8 nibble bytes")
    out = _raw_code_gemm(x_codes, w_packed, 2 * w_packed.shape[1],
                         packed=True)
    fxp4_gemm_packed.launches += 1
    return out


fxp4_gemm_packed.launches = 0
