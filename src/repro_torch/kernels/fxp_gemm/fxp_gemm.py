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
  * x32       — int32 codes (FxP24/32, the PE's 1X FxP32 mode): products
                reach 2^62 and a sum over K rows needs more than 64 bits,
                so the exact sum is held in 128 bits and rounded once to
                f32 (to nearest even) in integer arithmetic, never through
                f64, which would round twice. The plain version sums
                16-bit halves of the codes (`limb_matmul`, rounded by
                `limbs_to_f32`); the kernel splits each code into four
                byte planes, a signed top byte and three unsigned ones,
                whose 16 int8 tensor-core products go to seven int32
                accumulators by their weight 2^(8s) and combine in 128
                bits (`x32_plane_matmul` is that arithmetic in plain
                PyTorch);
  * batched and batched_packed — the expert banks, int8 or packed.
Every mode, and the raw int8, int16 and packed code GEMMs, runs on one
tensor-core core (`fxp_gemm_tc_kernel`): `mma.sync` tiles fed by
asynchronous copies, the nibbles of packed weights turned into int8
fragments in registers as 16 times their codes, the factor shifted off
the exact int32 sum. The grid splits K across blocks to fill the card
(`k_split`); a bank's grid walks its experts (an int8 bank's blocks, as
many as fit on the card, claim its items from a counter), and an item
whose activation rows hold no code reads no weight bytes
(csrc/fxp_gemm.cu says what bounds each mode and what its design does
about it). At decode every
one of them is bound by reading the weight once.
The reference's Pallas kernel sums codes wider than 8 bits in f32 in
XLA's order (int32 only under its `wide_exact` bound K * qmax^2 < 2^31,
where this port equals it bit for bit; int32 codes are first rounded to
f32 themselves); the port's exact sum is within one f32 rounding per
step of the reference's.

`fxp_gemm_codes` and `fxp4_gemm_packed` are the raw code GEMMs: the exact
int32 product with no epilogue, on int8 or wider codes (the caller owns the
bound K * qmax^2 < 2^31 past 8 bits), or on packed FxP4 weights; on int32
codes a plain tiled int32 multiply-add on the CUDA cores.

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
           "exact_matmul", "byte_plane_matmul", "x32_plane_matmul",
           "limb_matmul", "limbs_to_f32", "k_split", "GEMM_MODES",
           "reset_launches"]

#: AFs the fused epilogue supports (the Flex-PE Sel_AF set minus softmax).
FUSED_AFS = KERNEL_AFS

_SMS = 132            # H100 SXM streaming multiprocessors
_TC_ROW_BYTES = 128   # tc::kRowBytes in csrc/fxp_gemm.cu (the tensor-core
                      # core): a block's columns, 128 int8, 64 int16, 32
                      # int32 or 256 packed FxP4 codes
_TC_BLOCK_K = 128     # tc::kBK: k rows per stage
_MAX_KPS_WIDE = 32768  # tc::kMaxKSplitWide: 2 * 128 * 255 * 32768 < 2^31
_MAX_ACC_ROWS_X32 = 8192  # tc::kMaxAccRowsX32: rows one int32 accumulator
                          # of the x32 mode sums at most (a warp's quarter
                          # of a block's slice); 8192 * 195330 < 2^31
_PLAIN_COLS = 16384   # column chunk of the plain product (bounds its f64)
_PLANE_K = 1 << 20    # K rows of a plain f64 product of 16-bit halves
# bytes of a code, by dtype (else int8); a split-K workspace entry holds
# the exact sum in as many int32 words: int32 sums, int64 for int16
# codes, 128 bits for int32 codes
_CODE_BYTES = {torch.int16: 2, torch.int32: 4}

#: the fused GEMM's kernel modes, counted per launch
GEMM_MODES = ("int8", "packed", "wide", "x32", "batched", "batched_packed")


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


def x32_plane_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor,
                     rows: int = _MAX_ACC_ROWS_X32
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The x32 mode's arithmetic on int32 codes, in plain PyTorch -> two
    int64 limbs (hi, lo) [M, N] of the exact sum hi * 2^32 + lo with
    0 <= lo < 2^32, as `limb_matmul` gives them. Each code c splits into
    four byte planes, c = c3 2^24 + c2 2^16 + c1 2^8 + c0, a signed top
    byte c3 = c >> 24 and unsigned c2, c1, c0; the 16 plane products are
    summed into seven int32 accumulators by their weight 2^(8s), s = i + j,
    each over a K slice of `rows` rows (the kernel's cap, the most rows
    any of its accumulators sums) and wrapped to int32 as the kernel's
    would be; the groups then combine exactly, as the kernel's 128-bit
    sums do. For the tests, on CPU tensors (CUDA has no int64 product): no
    path calls it."""
    x = x_codes.to(torch.int64)
    w = w_codes.to(torch.int64)
    xp = [(x >> 8 * i) & 255 for i in range(3)] + [x >> 24]
    wp = [(w >> 8 * i) & 255 for i in range(3)] + [w >> 24]

    def acc32(v):                    # an int32 accumulator's sum
        return v.to(torch.int32).to(torch.int64)
    lo = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64)
    hi = torch.zeros_like(lo)        # the weight-2^32 groups
    for k0 in range(0, x.shape[1], rows):
        ks = slice(k0, k0 + rows)
        groups = [0] * 7
        for i in range(4):
            for j in range(4):
                groups[i + j] = groups[i + j] + xp[i][:, ks] @ wp[j][ks]
        g = [acc32(v) for v in groups]
        lo += g[0] + (g[1] << 8) + (g[2] << 16) + (g[3] << 24)
        hi += g[4] + (g[5] << 8) + (g[6] << 16) + (lo >> 32)
        lo &= 0xFFFFFFFF
    return hi, lo


def limb_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact integer product of codes of up to 32 bits, in plain
    PyTorch on any device -> two int64 limbs (hi, lo) [M, N], the sum
    being hi * 2^32 + lo with 0 <= lo < 2^32. Each code c splits into a
    signed high half h = c >> 16 and an unsigned low half l = c & 0xFFFF;
    the plane sums hh, hl + lh and ll of a K slice of at most 2^20 rows
    are f64 products of integers (each |sum| <= K * 2^32 < 2^53, exact in
    any order), added in int64 over the slices, and combined as
    (hh << 32) + ((hl + lh) << 16) + ll without leaving int64. Columns go
    in chunks to bound the f64 temporaries."""
    x = x_codes.to(torch.int64)
    xh, xl = (x >> 16).double(), (x & 0xFFFF).double()
    k = x.shape[1]
    his, los = [], []
    for j in range(0, w_codes.shape[1], _PLAIN_COLS):
        w = w_codes[:, j:j + _PLAIN_COLS].to(torch.int64)
        wh, wl = (w >> 16).double(), (w & 0xFFFF).double()
        hh = mid = ll = 0
        for k0 in range(0, k, _PLANE_K):
            ks = slice(k0, k0 + _PLANE_K)
            a, b, c, d = xh[:, ks], xl[:, ks], wh[ks], wl[ks]
            hh = hh + (a @ c).long()
            mid = mid + (a @ d + b @ c).long()
            ll = ll + (b @ d).long()
        lo = ((mid & 0xFFFF) << 16) + ll          # >= 0: l and ll are
        his.append(hh + (mid >> 16) + (lo >> 32))  # unsigned
        los.append(lo & 0xFFFFFFFF)
    return torch.cat(his, dim=1), torch.cat(los, dim=1)


def limbs_to_f32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """hi * 2^32 + lo (0 <= lo < 2^32) rounded once to f32, to nearest
    even. Where the sum fits in int64 (-2^31 <= hi < 2^31) it is formed
    and converted, which rounds once; past that (|sum| >= 2^63, where f32
    steps are 2^40 apart) the sum's bits below 2^32 only break ties, so
    2 hi + (lo != 0) holds the same rounding at 2^-31 of the scale: the
    low bit marks a sum strictly between two multiples of 2^32, where no
    f32 value or midpoint lies. Both converted values are exact in int64
    and round once; the power-of-two scale is exact."""
    fits = (hi >= -(1 << 31)) & (hi < (1 << 31))
    exact = (hi.clamp(-(1 << 31), (1 << 31) - 1) << 32) + lo
    sticky = (hi << 1) | (lo != 0).long()
    return torch.where(fits, exact.float(), sticky.float() * 2.0 ** 31)


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
    to 32 bits (int32 codes through `limb_matmul`); `packed` weights are
    unpacked first."""
    if packed:
        w_codes = unpack_nibbles(w_codes, scale.numel())
    if torch.int32 in (x_codes.dtype, w_codes.dtype):
        acc = limbs_to_f32(*limb_matmul(x_codes, w_codes))
    else:
        acc = exact_matmul(x_codes, w_codes).float()
    out = acc * scale.reshape(1, -1)
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
    """(columns per block, row tiles) of the tensor-core core's grid, for
    codes of dtype `core` (int8 when None, int16 or int32) or packed
    weights: a stage row of 128 bytes of columns (128 int8, 64 int16, 32
    int32 or 256 packed FxP4 codes); tiles of 8, 16 or 32 rows (16 at most
    for int16 and int32 codes)."""
    size = _CODE_BYTES.get(core, 1)
    rows = 8 if m <= 8 else 16 if m <= 16 or size > 1 else 32
    cols = (2 if packed else 1) * _TC_ROW_BYTES // size
    return cols, -(-m // rows)


def k_split(m: int, k: int, n: int, experts: int = 1,
            packed: bool = False, core=None) -> int:
    """K rows per block of the tensor-core core (`core` and `packed` as for
    `_tiles`; `experts` counts a bank's tiles): about one block per SM for
    int8 codes (what measured fastest at the paths' decode shapes:
    tools/gemm_split_sweep.py) and for packed weights' 32-row tiles (whose
    256 threads hold over half an SM's registers), else (int16 codes,
    packed tiles of up to 16 rows) as many as fit two to an SM, at least
    256 rows each; for int32 codes the fewest slices whose items fill the
    last wave of two blocks an SM to 90% (`_x32_splits`). At most
    `_MAX_KPS_WIDE` rows, a multiple of a stage's 128 rows."""
    block_n, m_tiles = _tiles(m, packed, core)
    tiles = -(-n // block_n) * m_tiles * experts
    least = -(-k // _MAX_KPS_WIDE)
    if core == torch.int32:
        splits = max(least, _x32_splits(k, tiles))
    else:
        int8 = not packed and core in (None, torch.int8)
        resident = _SMS if int8 or (packed and m > 16) else 2 * _SMS
        splits = max(least, min(max(1, resident // tiles), -(-k // 256)))
    kps = -(-k // splits)
    return -(-kps // _TC_BLOCK_K) * _TC_BLOCK_K


def _x32_splits(k: int, tiles: int) -> int:
    """K slices of the x32 mode over `tiles` (column tile, row tile)
    items: two blocks fit an SM, and a grid of items runs in waves of
    2 * 132. The fewest slices, of at least 640 rows (five stages), whose
    items fill the last wave to 90%, else the fullest; one H100 run of
    tools/gemm_split_sweep.py --x32 found these fastest or within 4% of
    the fastest at Qwen2.5-14B's shapes (4 x 5120 x 13824: 1 slice
    120.5 us, 3 slices 116.7; 4 x 13824 x 5120: 1 slice 128.9, 3 slices
    115.4, 5 slices 107.9)."""
    resident = 2 * _SMS

    def fill(splits):
        items = tiles * splits
        return items / (-(-items // resident) * resident)
    most = max(1, k // 640)
    return next((s for s in range(1, most + 1) if fill(s) >= 0.9),
                max(range(1, most + 1), key=fill))


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
               "fxp_gemm_fused_x32": ([_P] * 6 + [_I] * 7 + [_P, _P],
                                      ctypes.c_int),
               "fxp_gemm_codes_int8": ([_P] * 5 + [_I] * 7 + [_P],
                                       ctypes.c_int),
               "fxp_gemm_codes_int16": ([_P] * 5 + [_I] * 5 + [_P],
                                        ctypes.c_int),
               "fxp_gemm_codes_int32": ([_P] * 3 + [_I] * 3 + [_P],
                                        ctypes.c_int)}


def _workspace(x_codes, e, m, k, n, packed, core=None, handout=False):
    """(kps, workspace, semaphore pointer), zeroed: with split K a
    workspace [E, M, N] (int32; int64 for int16 codes, 128 bits for int32
    codes) and one int32 semaphore per (expert, tile); then, with
    `handout` (int8 banks), the counter from which the kernel hands out
    its items."""
    kps = k_split(m, k, n, e, packed, core)
    assert kps <= _MAX_KPS_WIDE, "a block's int32 plane sums would overflow"
    block_n, m_tiles = _tiles(m, packed, core)
    split = kps < k
    acc = _CODE_BYTES.get(core, 1) * e * m * n * split
    sems = -(-n // block_n) * m_tiles * e * split + int(handout)
    ws = torch.zeros(max(1, acc + sems), dtype=torch.int32,
                     device=x_codes.device)
    return kps, ws, ws[acc:].data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(mode):
    fxp_gemm_fused.launches += 1
    fxp_gemm_fused.launches_by_mode[mode] += 1


def _launch(x_codes, w_codes, scale, af, hr_stages, lv_stages, experts,
            packed=False):
    """One launch over x [E, M, K], w [E, K, N] (or packed bytes [E, K,
    NB]), scale [E, N] (CUDA, int8 codes, checked by the callers) -> f32
    [E, M, N] on the tensor-core core: the expert bank, or for E = 1
    without `experts` the single product."""
    e, m, k = x_codes.shape
    n = scale.numel() // e
    x_codes = x_codes.contiguous()
    w_codes = w_codes.contiguous()
    scale = scale.reshape(e, n).to(torch.float32).contiguous()
    out = torch.empty((e, m, n), dtype=torch.float32, device=x_codes.device)
    kps, ws, sem = _workspace(x_codes, e, m, k, n, packed,
                              handout=experts and not packed)
    ldb = w_codes.shape[2]
    vec = _tc_vec(x_codes, w_codes)
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
    """One launch of the tensor-core core over int16 (the wide mode) or
    int32 codes (the x32 mode) x [M, K], w [K, N] of one dtype and scale
    [N] (CUDA, checked by the caller) -> f32 [M, N]."""
    m, k = x_codes.shape
    n = scale.numel()
    x_codes = x_codes.contiguous()
    w_codes = w_codes.contiguous()
    scale = scale.reshape(n).to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x_codes.device)
    core = x_codes.dtype
    kps, ws, sem = _workspace(x_codes, 1, m, k, n, False, core)
    vec = _tc_vec(x_codes, w_codes)
    lib = library("fxp_gemm", _SIGNATURES)
    mode = "x32" if core == torch.int32 else "wide"
    entry = (lib.fxp_gemm_fused_x32 if mode == "x32"
             else lib.fxp_gemm_fused_wide)
    err = entry(x_codes.data_ptr(), w_codes.data_ptr(), scale.data_ptr(),
                out.data_ptr(), ws.data_ptr(), sem, m, k, n, kps, vec,
                AF_CODE[af], lv_stages, ctypes.byref(cordic_params(hr_stages)),
                _stream(x_codes))
    if err != 0:
        raise RuntimeError(f"fxp_gemm_fused {mode} launch failed: CUDA "
                           f"error {err}")
    _count(mode)
    return out


_KERNEL_CODES = (torch.int8, torch.int16, torch.int32)


def _check_kernel_operands(x_codes, w_codes, scale):
    if x_codes.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_codes.device}")
    for t in (w_codes, scale):
        if t.device != x_codes.device:
            raise ValueError("operands on different devices")
    if (x_codes.dtype not in _KERNEL_CODES
            or w_codes.dtype not in _KERNEL_CODES):
        raise NotImplementedError(
            f"fxp_gemm_fused kernel takes int8, int16 or int32 codes, not "
            f"{x_codes.dtype} and {w_codes.dtype}")


def _check_packed(w_bytes, n):
    if w_bytes.dim() != 2 or not 0 < n <= 2 * w_bytes.shape[1]:
        raise ValueError(f"packed weight {tuple(w_bytes.shape)} holds at "
                         f"most {2 * w_bytes.shape[-1]} columns, not {n}")


def fxp_gemm_fused(x_codes: torch.Tensor, w_codes: torch.Tensor,
                   scale: torch.Tensor, af: Optional[str] = None,
                   hr_stages: int = 4, lv_stages: int = 5,
                   packed: bool = False) -> torch.Tensor:
    """x_codes [M, K] @ w_codes [K, N] -> f32 [M, N] = AF(acc * scale[N]),
    on int8 codes, int16 codes (the wide mode) or int32 codes (the x32
    mode; a narrower operand beside a wider one is widened); with
    `packed`, w_codes is packed FxP4 bytes [K, NB] and N = scale.numel().
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
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
    if packed and torch.int8 != x_codes.dtype:
        raise ValueError("packed weights hold FxP4 codes; the activation "
                         "codes must be int8")
    for wide in (torch.int32, torch.int16):
        if wide in (x_codes.dtype, w_codes.dtype):
            return _launch_wide(x_codes.to(wide), w_codes.to(wide), scale,
                                af, hr_stages, lv_stages)
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
