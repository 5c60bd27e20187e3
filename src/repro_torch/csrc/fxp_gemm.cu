// fxp_gemm_fused — the Flex-PE MAC array with its fused dequant + AF
// epilogue, written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fxp_gemm/fxp_gemm.py, fxp_gemm_fused_pallas
// (body _gemm_kernel_fused). Computes
//     out[m, n] = AF( float(sum_k A[m, k] * B[k, n]) * scale[n] )
// with A int8 [M, K] activation codes, B int8 [K, N] weight codes (the
// quantize-once [K, N] layout, unchanged), scale f32 [N] and an int32
// accumulator: integer sums are exact in any order, so the result is
// bit-identical to the plain version for K * 127^2 < 2^31.
//
// The batched entry runs E such products in one launch, one per MoE
// expert: A [E, M, K], B [E, K, N], scale [E, N], out [E, M, N]. The grid's
// z axis walks (expert, row tile); every expert's blocks compute exactly
// what the single-matrix launch computes on that expert's operands, so
// the result is bit-equal to a loop of single launches.
//
// What bounds it: at decode M is the slot count (4), so every weight byte
// is used M times — about 2M integer operations per byte, far below the
// card's ~590 int8 operations per byte of memory bandwidth. The kernel is
// bound by reading B once (K*N bytes over 3.35 TB/s).
//
// What the design does about it:
//  * B streams through once, coalesced: a warp reads 128 consecutive bytes
//    of a row (4 columns per lane), four rows at a time; four __byte_perm
//    pairs transpose the 4x4 byte tile so that each column's four k values
//    share a word, and __dp4a multiplies it with four packed activation
//    codes from shared memory (the whole A slice is staged once per block).
//  * Decode has few column tiles (N/128), so K is split across blocks to
//    fill the 132 SMs: each block reduces its eight warps in shared memory,
//    adds its partial tile into an int32 workspace with atomics (exact in
//    any order), and the last block to arrive at a tile — counted by a
//    per-tile semaphore — applies the epilogue. One launch, as on the TPU.
//  * Ragged edges are masked (zero codes contribute nothing), never padded.
//  * Expert banks only (a second instantiation, so the single-matrix
//    kernel compiles as before): a row of zero codes adds nothing, so a
//    block skips the products of the rows its staged A slice holds only
//    zeros in, and when all its rows are zero, its B loads too. At decode
//    4 tokens route to at most 24 of 64 experts: the unfilled queue slots
//    cost no products, and an expert no token routes to costs no weight
//    bytes.
//  * Packed FxP4 weights (a third instantiation, so the int8 entries
//    compile as before): B holds two codes per byte, byte j of a row's
//    word holding elements 2j (low nibble) and 2j+1 (high), the lane order
//    of core.simd.pack. A lane's 32-bit load then carries 8 columns of one
//    k row; the nibbles are sign-extended in registers to two int8x4 words
//    (even and odd columns), each transposed and fed to __dp4a as above, so
//    a warp covers 256 columns and B moves half the int8 bytes. The H100
//    has no int4 tensor-core rate: unpacking before the product is the
//    route, as the TPU kernel's _unpack_nibbles is.
//  * Packed FxP4 expert banks (a fourth instantiation): the expert bank's
//    grid and zero-row skip over the packed walk, B [E, K, ldb] bytes.
//
// The tensor-core core (namespace tc, fxp_gemm_tc_kernel) runs the raw
// int8 code GEMM and every GEMM of codes wider than 8 bits (FxP12/16 in
// int16): the fused GEMM's wide mode and the raw int16 code GEMM.
//  * What bounds it: at decode, and at the raw GEMM's 32 rows, each weight
//    code is used at most 32 times, far below the ~590 int8 operations per
//    byte at which the tensor cores would take over from the memory, so
//    reading B once bounds it. A __dp4a walk on the CUDA cores cannot
//    reach that bound (M 32 x 5120 x 5120 needs 210 M dp4a, ~14 us at 64
//    a clock per SM, against 7.8 us for B's bytes), nor can sums of int16
//    products in f64, at the CUDA cores' low f64 rate.
//  * mma.sync m16n8k32 on s8/u8 operands with int32 accumulators, the
//    operands swapped: the weight's columns are the MMA's 16 rows and the
//    activation rows its 8 columns, so 4 decode rows pad half of a tile.
//  * Byte planes: an int16 code c is h * 256 + l, with a signed high byte
//    h = c >> 8 in [-128, 127] and an unsigned low byte l = c & 255. Four
//    products per tile, hh (s8.s8), hl (s8.u8), lh (u8.s8) and ll
//    (u8.u8), the middle two into one accumulator, combine exactly in
//    int64: (hh << 16) + ((hl + lh) << 8) + ll. Each int32 partial is
//    exact while a block's K slice is at most kMaxKSplitWide = 32768 rows
//    (2 * 128 * 255 * 32768 < 2^31). The fused mode rounds the exact sum
//    once to f32 (__ll2float_rn) before the int8 mode's epilogue:
//    bit-equal to the plain version's exact f64 sum while K * 2^30 < 2^53,
//    and to the reference under its wide_exact bound (K * qmax^2 < 2^31;
//    past it the reference sums in f32 in XLA's order, within one f32
//    rounding per step of the exact sum). The raw int16 GEMM writes the
//    low 32 bits: the wrapping int32 sum of the reference's int32 dot.
//  * The quantize-once [K, N] layout stays. B streams through a ring of
//    four stages in shared memory (128 k rows of 128 bytes: 128 int8 or
//    64 int16 columns, with the activation slice beside it), filled by
//    cp.async.cg 16-byte copies whose chunks are XOR-swizzled so that a
//    warp's loads hit distinct banks; each thread's copy addresses are
//    worked out once, before the k loop. A lane reads 8 columns of 8 k
//    rows and transposes them in registers (transpose4, after __byte_perm
//    splits int16 codes into planes) into k-contiguous fragments. A warp
//    takes 64 columns and its own k32 steps of each stage (for int16
//    codes all 64 columns of the block), so every activation code is split
//    once per block.
//  * K is split across blocks to fill the SMs at decode's few column
//    tiles, up to two blocks per SM (more would wait for a second wave):
//    the warps' partial tiles are summed in shared memory, each block adds
//    its tile into a workspace with atomics (int32; int64 for int16
//    codes, whose unsigned long long atomics wrap exactly for signed
//    values), and the last block of a tile, counted by a semaphore,
//    applies the epilogue. The epilogue is bound by latency, not by
//    bandwidth: each thread owns one column (its scale read before the k
//    loop) and issues all its loads before its first store. At the raw
//    GEMM's 32 rows (240 blocks) streaming B takes ~10 us and the split's
//    tail (the adds, the semaphore, the last block's read and write) ~5.
//
// Raw code GEMMs (src/repro/kernels/fxp_gemm/fxp_gemm.py, fxp_gemm_pallas
// and fxp4_gemm_packed_pallas) write the int32 sums as they are: int8 and
// int16 codes on the tensor-core core, packed FxP4 weights on the __dp4a
// walk's raw mode, int32 codes on a plain tiled int32 multiply-add
// (gemm_codes_wide_kernel). As in the reference, the caller owns the
// overflow-free bound K * qmax^2 < 2^31 past 8 bits.
// Not yet: wgmma and TMA (at M <= 32 these shapes are bound by bytes, far
// below mma.sync's integer rate); a balanced (stream-K) split of K, so
// that 240 blocks do not leave a fifth of the 132 SMs idle for the second
// half of the k loop; bulk asynchronous reductions of the split's tiles;
// and the int8 fused, packed and expert-bank modes on the tensor-core
// core.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "cordic.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 128;       // int8 weights: 32 lanes x 4 columns
constexpr int kMaxKSplit = 1024;   // K rows per block (A slice in smem)

// what B holds, and how the grid's z axis is read
constexpr int kDense = 0;          // int8 codes [K, N]
constexpr int kExpertBank = 1;     // int8 codes [E, K, N], z = (expert, tile)
constexpr int kPackedFxP4 = 2;     // nibble bytes [K, ldb], N <= 2 * ldb
constexpr int kPackedBank = 3;     // nibble bytes [E, K, ldb], z as kExpertBank

__host__ __device__ constexpr bool is_packed(int mode) {
  return mode == kPackedFxP4 || mode == kPackedBank;
}

// 4x4 byte transpose: word j of `r` holds four columns of row j; column
// c's result word holds rows 0..3 of column c
__device__ __forceinline__ void transpose4(const unsigned (&r)[4],
                                           int (&col)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
  const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  col[0] = static_cast<int>(__byte_perm(t0, t2, 0x5410));
  col[1] = static_cast<int>(__byte_perm(t0, t2, 0x7632));
  col[2] = static_cast<int>(__byte_perm(t1, t3, 0x5410));
  col[3] = static_cast<int>(__byte_perm(t1, t3, 0x7632));
}

// four nibbles (bits 0-3 of each byte of `w`) sign-extended to four int8
// bytes: (v ^ 8) - 8 per byte maps 0..7 to 0..7 and 8..15 to -8..-1
__device__ __forceinline__ unsigned sext_nibbles(unsigned w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

template <int MT, int kMode, bool kRaw>
__global__ void __launch_bounds__(kThreads)
fxp_gemm_fused_kernel(const int8_t* __restrict__ A,
                      const int8_t* __restrict__ B,
                      const float* __restrict__ scale,
                      void* __restrict__ out_, int* __restrict__ ws,
                      unsigned* __restrict__ counters, int M, int K, int N,
                      int ldb, int kps, int vec, int af, int lv_n,
                      CordicParams cp) {
  constexpr bool kExperts = kMode == kExpertBank || kMode == kPackedBank;
  constexpr bool kPacked = is_packed(kMode);
  constexpr int kBN = kPacked ? 2 * kBlockN : kBlockN;   // block columns
  constexpr int kC = kBN / 32;                            // lane columns
  __shared__ int a_s[MT][kMaxKSplit / 4];
  __shared__ int tile[MT][kBN];
  __shared__ int is_last;
  __shared__ unsigned live;                  // bit m: row m0+m has a code

  int m0 = blockIdx.z * MT;
  if constexpr (kExperts) {
    // blockIdx.z = expert * (row tiles) + row tile
    const int m_tiles = (M + MT - 1) / MT;
    const int expert = blockIdx.z / m_tiles;
    A += static_cast<size_t>(expert) * M * K;
    B += static_cast<size_t>(expert) * K * (kPacked ? ldb : N);
    scale += static_cast<size_t>(expert) * N;
    out_ = static_cast<float*>(out_) + static_cast<size_t>(expert) * M * N;
    ws += static_cast<size_t>(expert) * M * N;
    m0 = (blockIdx.z - expert * m_tiles) * MT;
  }
  const int n0 = blockIdx.x * kBN;
  const int k0 = blockIdx.y * kps;
  const int k1 = min(K, k0 + kps);
  const int kw = (k1 - k0 + 3) / 4;          // packed words of this slice
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // stage A[m0:m0+MT, k0:k1] as words of four k-consecutive codes (whole
  // word loads for the expert banks, whose rows start on a word)
  if constexpr (kExperts) {
    if (tid == 0) live = 0;
    __syncthreads();
  }
  const bool a_words = kExperts && K % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(A) % 4 == 0;
  unsigned rows = 0;
  for (int i = tid; i < MT * kw; i += kThreads) {
    const int m = i / kw;
    const int w = i - m * kw;
    unsigned packed = 0;
    if (a_words) {
      if (m0 + m < M) {
        packed = __ldg(reinterpret_cast<const unsigned*>(
                           A + static_cast<size_t>(m0 + m) * K + k0) + w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 4 * w + j;
        const unsigned v = (m0 + m < M && k < k1)
            ? static_cast<unsigned>(static_cast<uint8_t>(
                  A[static_cast<size_t>(m0 + m) * K + k]))
            : 0u;
        packed |= v << (8 * j);
      }
    }
    a_s[m][w] = static_cast<int>(packed);
    if (kExperts && packed) rows |= 1u << m;
  }
  for (int i = tid; i < MT * kBN; i += kThreads) {
    tile[i / kBN][i % kBN] = 0;
  }
  // expert banks: rows of zero codes contribute exact zeros, so skip their
  // products, and the B loads of a slice that has no other rows
  unsigned live_rows = ~0u;
  if constexpr (kExperts) {
    rows = __reduce_or_sync(0xffffffffu, rows);
    if (lane == 0 && rows) atomicOr(&live, rows);
  }
  __syncthreads();
  if constexpr (kExperts) live_rows = live;
  const int g0 = live_rows ? warp : kw;

  int acc[MT][kC];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[m][c] = 0;
  }

  const int n = n0 + kC * lane;
  for (int g = g0; g < kw; g += kWarps) {
    const int kb = k0 + 4 * g;
    unsigned r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kb + j;
      unsigned word = 0;
      if (k < k1 && n < N) {
        if constexpr (kPacked) {
          // columns n..n+7 are bytes n/2..n/2+3 of the row
          const int8_t* row = B + static_cast<size_t>(k) * ldb + n / 2;
          if (vec) {
            word = __ldg(reinterpret_cast<const unsigned*>(row));
          } else {
            for (int c = 0; c < 4; ++c) {
              if (n / 2 + c < ldb) {
                word |= static_cast<unsigned>(static_cast<uint8_t>(row[c]))
                        << (8 * c);
              }
            }
          }
        } else {
          const int8_t* row = B + static_cast<size_t>(k) * N;
          if (vec) {
            word = __ldg(reinterpret_cast<const unsigned*>(row + n));
          } else {
            for (int c = 0; c < 4; ++c) {
              if (n + c < N) {
                word |= static_cast<unsigned>(
                            static_cast<uint8_t>(row[n + c]))
                        << (8 * c);
              }
            }
          }
        }
      }
      r[j] = word;
    }
    // col[c]: rows kb..kb+3 of lane column c, as four int8 codes
    int col[kC];
    if constexpr (kPacked) {
      // low nibbles hold the even columns n+2c, high nibbles the odd ones
      unsigned lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = sext_nibbles(r[j]);
        hi[j] = sext_nibbles(r[j] >> 4);
      }
      int even[4], odd[4];
      transpose4(lo, even);
      transpose4(hi, odd);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        col[2 * c] = even[c];
        col[2 * c + 1] = odd[c];
      }
    } else {
      int four[4];
      transpose4(r, four);
#pragma unroll
      for (int c = 0; c < 4; ++c) col[c] = four[c];
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (!kExperts || (live_rows & (1u << m))) {    // uniform block-wide
        const int a = a_s[m][g];
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[m][c] = __dp4a(col[c], a, acc[m][c]);
      }
    }
  }

  // reduce the eight warps' partial sums in shared memory (exact)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (acc[m][c] != 0) atomicAdd(&tile[m][kC * lane + c], acc[m][c]);
    }
  }
  __syncthreads();

  const bool split = gridDim.y > 1;
  if (split) {
    // add this block's partial tile into the workspace, then let the last
    // block of the tile apply the epilogue
    for (int i = tid; i < MT * kBN; i += kThreads) {
      const int m = i / kBN;
      const int c = i % kBN;
      if (m0 + m < M && n0 + c < N && tile[m][c] != 0) {
        atomicAdd(&ws[static_cast<size_t>(m0 + m) * N + n0 + c], tile[m][c]);
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const unsigned prev =
          atomicAdd(&counters[blockIdx.z * gridDim.x + blockIdx.x], 1u);
      is_last = prev == gridDim.y - 1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
  }

  for (int i = tid; i < MT * kBN; i += kThreads) {
    const int m = i / kBN;
    const int c = i % kBN;
    const int row = m0 + m;
    const int cn = n0 + c;
    if (row < M && cn < N) {
      const size_t o = static_cast<size_t>(row) * N + cn;
      const int total = split ? __ldcg(&ws[o]) : tile[m][c];
      if constexpr (kRaw) {
        static_cast<int*>(out_)[o] = total;
      } else {
        const float v = __fmul_rn(static_cast<float>(total), scale[cn]);
        static_cast<float*>(out_)[o] = apply_af(v, af, cp, lv_n);
      }
    }
  }
}

template <int MT, int kMode, bool kRaw>
cudaError_t launch(const int8_t* a, const int8_t* b, const float* scale,
                   void* out, int* ws, unsigned* counters, int E, int M,
                   int K, int N, int ldb, int kps, int vec, int af, int lv_n,
                   const CordicParams& cp, cudaStream_t stream) {
  constexpr int kBN = is_packed(kMode) ? 2 * kBlockN : kBlockN;
  const int splits = (K + kps - 1) / kps;
  dim3 grid((N + kBN - 1) / kBN, splits, E * ((M + MT - 1) / MT));
  fxp_gemm_fused_kernel<MT, kMode, kRaw><<<grid, kThreads, 0, stream>>>(
      a, b, scale, out, ws, counters, M, K, N, ldb, kps, vec, af, lv_n, cp);
  return cudaGetLastError();
}

// Row tiles of 4, 8 or 16 rows (8 at most for packed weights, whose lanes
// hold twice the columns and so twice the accumulators).
template <int kMode, bool kRaw>
int dispatch(const int8_t* a, const int8_t* b, const float* scale, void* out,
             int* ws, unsigned* counters, int E, int M, int K, int N, int ldb,
             int kps, int vec, int af, int lv_n, const CordicParams* cp,
             void* stream) {
  const int max_mt = is_packed(kMode) ? 8 : 16;
  if (E <= 0 || M <= 0 || N <= 0 || K <= 0 || kps <= 0 ||
      kps > kMaxKSplit || kps % 4 != 0 ||
      (is_packed(kMode) && (ldb <= 0 || N > 2 * ldb)) ||
      static_cast<long long>(E) * ((M + max_mt - 1) / max_mt) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 4) {
    return static_cast<int>(launch<4, kMode, kRaw>(
        a, b, scale, out, ws, counters, E, M, K, N, ldb, kps, vec, af, lv_n,
        *cp, s));
  }
  if constexpr (is_packed(kMode)) {
    return static_cast<int>(launch<8, kMode, kRaw>(
        a, b, scale, out, ws, counters, E, M, K, N, ldb, kps, vec, af, lv_n,
        *cp, s));
  } else {
    if (M <= 8) {
      return static_cast<int>(launch<8, kMode, kRaw>(
          a, b, scale, out, ws, counters, E, M, K, N, ldb, kps, vec, af,
          lv_n, *cp, s));
    }
    return static_cast<int>(launch<16, kMode, kRaw>(
        a, b, scale, out, ws, counters, E, M, K, N, ldb, kps, vec, af, lv_n,
        *cp, s));
  }
}


// ---------------------------------------------------------------------------
// The tensor-core core: byte planes on mma.sync m16n8k32 (s8/u8)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 128;          // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = 128;         // a stage's weight row: 128 int8 or
                                       // 64 int16 codes
constexpr int kBK = 128;               // k rows per stage
constexpr int kStages = 4;             // the ring of stages
// K rows per block: each int32 plane partial stays exact
// (2 * 128 * 255 * 32768 < 2^31)
constexpr int kMaxKSplitWide = 32768;

// A block over codes T with MT activation rows: kBN output columns in
// groups of 64, one group per warp, the warps of a group taking turns
// over a stage's k32 steps. Shared memory per stage: kBK weight rows of
// kRowBytes, then MT activation rows of kBK codes (padded by 16 codes,
// so that a warp's fragment loads hit distinct banks); after the k loop
// the same bytes hold the warps' partial tiles.
template <typename T, int MT>
struct Shape {
  static constexpr int kBN = kRowBytes / sizeof(T);
  static constexpr int kGroups = kBN / 64;
  static constexpr int kKWarps = kWarps / kGroups;     // warps per group
  static constexpr int kSteps = kBK / (32 * kKWarps);  // k32 steps a warp
  static_assert(kGroups >= 1 && kWarps % kGroups == 0 && kSteps >= 1 &&
                    kBK % (32 * kKWarps) == 0,
                "a stage's k32 steps must divide among a group's warps");
  static constexpr int kWBytes = kBK * kRowBytes;
  static constexpr int kAStride = (kBK + 16) * sizeof(T);
  static constexpr int kStageBytes = kWBytes + MT * kAStride;
  // int8 codes: one int32 product; int16: the exact int64 plane sum
  using Acc = typename std::conditional<sizeof(T) == 1, int, long long>::type;
  // the partial tiles' rows, padded by one so that the warps' writes
  // spread over the banks
  static constexpr int kRedStride = kBN + 1;
  static constexpr int kRedBytes = kKWarps * MT * kRedStride * sizeof(Acc);
  static constexpr int kSmem = kStages * kStageBytes > kRedBytes
                                   ? kStages * kStageBytes : kRedBytes;
};

// Byte offset of byte b of weight row r in a stage: the rows one after the
// other, each 16-byte chunk XORed with 2 * ((r >> 2) & 3), so that rows
// 4t + j (t = 0..3), which one load instruction of a warp reads, land in
// distinct banks.
__device__ __forceinline__ int w_off(int r, int b) {
  const int chunk = (b >> 4) ^ (((r >> 2) & 3) << 1);
  return r * kRowBytes + (chunk << 4) + (b & 15);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// d += a (16 x 32, row-major) * b (32 x 8, column-major), int32
// accumulators; kSA / kSB: a's / b's bytes are signed (s8) or not (u8)
template <bool kSA, bool kSB>
__device__ __forceinline__ void mma_k32(int (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
#define FXP_MMA(TA, TB)                                                     \
  asm("mma.sync.aligned.m16n8k32.row.col.s32." TA "." TB ".s32 "            \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"   \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  if constexpr (kSA && kSB) {
    FXP_MMA("s8", "s8");
  } else if constexpr (kSA) {
    FXP_MMA("s8", "u8");
  } else if constexpr (kSB) {
    FXP_MMA("u8", "s8");
  } else {
    FXP_MMA("u8", "u8");
  }
#undef FXP_MMA
}

// A thread's share of the copies into a stage, fixed over the k loop:
// 16-byte chunks of weight rows wr + kWRows q (chunk column wc) and of
// activation rows ar + kARows q (chunk column ac); `issue` copies stage s
// (k rows k0 + kBK s ..): rows past k1, columns past N and activation rows
// past M are zero. `vec` bit 0 / bit 1: B's / A's rows are 16-byte aligned
// (then cp.async copies, else plain loads of single codes).
template <typename T, int MT>
struct CopyPlan {
  using S = Shape<T, MT>;
  static constexpr int kPer = 16 / sizeof(T);          // codes per chunk
  static constexpr int kWCols = kRowBytes / 16;
  static constexpr int kWRows = kThreads / kWCols;     // weight rows a pass
  static constexpr int kACols = kBK / kPer;
  static constexpr int kARows = kThreads / kACols;     // activation rows
  static_assert(kWRows % 4 == 0, "a pass keeps the rows' swizzle");

  const T* A;
  const T* B;
  int M, K, N, m0, n0, k0, k1, vec, tid;
  int wr, wc, ar, ac, wdst, adst;
  size_t wsrc, asrc;                 // element offsets of stage 0's chunks

  __device__ __forceinline__ CopyPlan(const T* A_, const T* B_, int M_,
                                      int K_, int N_, int m0_, int n0_,
                                      int k0_, int k1_, int vec_, int tid_)
      : A(A_), B(B_), M(M_), K(K_), N(N_), m0(m0_), n0(n0_), k0(k0_),
        k1(k1_), vec(vec_), tid(tid_), wr(tid_ / kWCols), wc(tid_ % kWCols),
        ar(tid_ / kACols), ac(tid_ % kACols) {
    // row wr + kWRows q has row wr's swizzle: (kWRows q >> 2) & 3 == 0
    wdst = w_off(wr, 16 * wc);
    adst = S::kWBytes + ar * S::kAStride + 16 * ac;
    wsrc = static_cast<size_t>(k0 + wr) * N + n0 + wc * kPer;
    asrc = static_cast<size_t>(m0 + ar) * K + k0 + ac * kPer;
  }

  __device__ __forceinline__ void issue(unsigned char* st, int s) const {
    const int kb = k0 + s * kBK;
    if (vec & 1) {
      const bool col = n0 + wc * kPer < N;
#pragma unroll
      for (int q = 0; q < kBK / kWRows; ++q) {
        const bool ok = col && kb + wr + kWRows * q < k1;
        cp_async16(st + wdst + kWRows * q * kRowBytes,
                   B + (ok ? wsrc + static_cast<size_t>(s * kBK + kWRows * q)
                                        * N : 0), ok);
      }
    } else {
      for (int i = tid; i < kBK * S::kBN; i += kThreads) {
        const int r = i / S::kBN;
        const int c = i - r * S::kBN;
        const int k = kb + r;
        const T v = (k < k1 && n0 + c < N)
            ? B[static_cast<size_t>(k) * N + n0 + c] : T(0);
        *reinterpret_cast<T*>(st + w_off(r, c * sizeof(T))) = v;
      }
    }
    if (vec & 2) {
      const bool col = kb + ac * kPer < k1;
#pragma unroll
      for (int q = 0; q < (MT + kARows - 1) / kARows; ++q) {
        const int m = ar + kARows * q;
        if (MT % kARows == 0 || m < MT) {
          const bool ok = col && m0 + m < M;
          cp_async16(st + adst + kARows * q * S::kAStride,
                     A + (ok ? asrc + static_cast<size_t>(kARows * q) * K +
                                   s * kBK : 0), ok);
        }
      }
    } else {
      unsigned char* as = st + S::kWBytes;
      for (int i = tid; i < MT * kBK; i += kThreads) {
        const int m = i / kBK;
        const int c = i - m * kBK;
        const int k = kb + c;
        const T v = (m0 + m < M && k < k1)
            ? A[static_cast<size_t>(m0 + m) * K + k] : T(0);
        *reinterpret_cast<T*>(as + m * S::kAStride + c * sizeof(T)) = v;
      }
    }
  }
};

// Lane (g, t) of a warp whose k rows start at `r0`: rows r0 + 16h + 4t + j
// (j = 0..3) of columns 8g..8g+7, four int8 codes to a word (x: columns
// 8g..8g+3, y: 8g+4..8g+7), transposed so that col[h][c] holds rows
// r0 + 16h + 4t .. +3 of column 8g + c: the A fragment words of MMA rows
// g (column 8g + 2i) and g + 8 (column 8g + 2i + 1) of tile i = 0..3.
__device__ __forceinline__ void transpose_rows(const unsigned (&x)[4],
                                               const unsigned (&y)[4],
                                               int (&col)[8]) {
  int cx[4], cy[4];
  transpose4(x, cx);
  transpose4(y, cy);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    col[c] = cx[c];
    col[4 + c] = cy[c];
  }
}

// int32 accumulators per lane: a plane (int8 codes: one; int16: hh,
// hl + lh, ll) x 4 MMA row tiles x NT column tiles x 4
template <typename T>
constexpr int kPlanes = sizeof(T) == 1 ? 1 : 3;

// One k32 step of a warp over stage `st`: weight rows r0..r0+31 of
// columns c0 + 8g .. c0 + 8g + 7 for lane (g, t), against the same k of
// the stage's activation rows. MMA tile i's row g is column c0 + 8g + 2i
// and its row g + 8 column c0 + 8g + 2i + 1; its column n is activation
// row 8 nt + n. `wl` and `al`: the lane's byte offsets in the stage of
// row 4t of its columns (swizzled: rows r0 + 16h + 4t + j share row 4t's
// swizzle) and of activation row g, k 4t.
template <typename T, int MT>
__device__ __forceinline__ void k32_step(
    const unsigned char* st, int r0, int wl, int al,
    int (&acc)[kPlanes<T>][4][MT / 8][4]) {
  using S = Shape<T, MT>;
  constexpr bool kWide = sizeof(T) == 2;
  constexpr int kP = kWide ? 2 : 1;          // byte planes of a code
  const unsigned char* w = st + wl + r0 * kRowBytes;
  // col[p][h][c]: rows r0 + 16h + 4t .. +3 of column c0 + 8g + c, plane p
  // (int16: 0 the high bytes, 1 the low bytes)
  int col[kP][2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned x[kP][4], y[kP][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned char* row = w + (16 * h + j) * kRowBytes;
      if constexpr (kWide) {
        const uint4 v = *reinterpret_cast<const uint4*>(row);
        x[0][j] = __byte_perm(v.x, v.y, 0x7531);
        x[kP - 1][j] = __byte_perm(v.x, v.y, 0x6420);
        y[0][j] = __byte_perm(v.z, v.w, 0x7531);
        y[kP - 1][j] = __byte_perm(v.z, v.w, 0x6420);
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(row);
        x[0][j] = v.x;
        y[0][j] = v.y;
      }
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) transpose_rows(x[p], y[p], col[p][h]);
  }
  const unsigned char* a0 = st + S::kWBytes + al + r0 * sizeof(T);
#pragma unroll
  for (int nt = 0; nt < MT / 8; ++nt) {
    // activation row 8 nt + g, k rows r0 + 4t .. and r0 + 16 + 4t ..
    const unsigned char* arow = a0 + nt * 8 * S::kAStride;
    unsigned bh[2], bl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (kWide) {
        const uint2 v = *reinterpret_cast<const uint2*>(arow + 32 * h);
        bh[h] = __byte_perm(v.x, v.y, 0x7531);
        bl[h] = __byte_perm(v.x, v.y, 0x6420);
      } else {
        bh[h] = bl[h] = *reinterpret_cast<const unsigned*>(arow + 16 * h);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned a[kP][4];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        a[p][0] = static_cast<unsigned>(col[p][0][2 * i]);
        a[p][1] = static_cast<unsigned>(col[p][0][2 * i + 1]);
        a[p][2] = static_cast<unsigned>(col[p][1][2 * i]);
        a[p][3] = static_cast<unsigned>(col[p][1][2 * i + 1]);
      }
      mma_k32<true, true>(acc[0][i][nt], a[0], bh[0], bh[1]);
      if constexpr (kWide) {
        mma_k32<true, false>(acc[1][i][nt], a[0], bl[0], bl[1]);
        mma_k32<false, true>(acc[1][i][nt], a[kP - 1], bh[0], bh[1]);
        mma_k32<false, false>(acc[2][i][nt], a[kP - 1], bl[0], bl[1]);
      }
    }
  }
}

template <typename T, int MT, bool kRaw>
__global__ void __launch_bounds__(kThreads)
fxp_gemm_tc_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   const float* __restrict__ scale, void* __restrict__ out_,
                   typename Shape<T, MT>::Acc* __restrict__ ws,
                   unsigned* __restrict__ counters, int M, int K, int N,
                   int kps, int vec, int af, int lv_n, CordicParams cp) {
  using S = Shape<T, MT>;
  using Acc = typename S::Acc;
  constexpr int kBN = S::kBN;
  constexpr int NT = MT / 8;                 // MMA column tiles (rows of A)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int n0 = blockIdx.x * kBN;
  const int k0 = blockIdx.y * kps;
  const int k1 = min(K, k0 + kps);
  const int m0 = blockIdx.z * MT;
  const int steps = (k1 - k0 + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int group = warp % S::kGroups;       // columns 64 group ..
  const int kwarp = warp / S::kGroups;       // k32 steps kwarp + kKWarps j
  // the epilogue: thread tid owns column c of the tile, rows
  // mr + kRowStep j; its scale is read before the k loop
  constexpr int kRowStep = kThreads / kBN;
  constexpr int kRows = MT / kRowStep;
  const int c = tid % kBN;
  const int mr = tid / kBN;
  const int cn = n0 + c;
  float sc = 0.f;
  if constexpr (!kRaw) {
    if (cn < N) sc = __ldg(scale + cn);
  }

  int acc[kPlanes<T>][4][NT][4];
#pragma unroll
  for (int p = 0; p < kPlanes<T>; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][i][nt][c] = 0;

  const CopyPlan<T, MT> plan(A, B, M, K, N, m0, n0, k0, k1, vec, tid);
  // the lane's fragment offsets (see k32_step): column c0 + 8g's byte in
  // row 4t, swizzled, and activation row g at k 4t
  const int cb = sizeof(T) * (64 * group + 8 * g);
  const int wl = 4 * t * kRowBytes + ((((cb >> 4) ^ (2 * t))) << 4) +
                 (cb & 15);
  const int al = g * S::kAStride + 4 * t * sizeof(T);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) plan.issue(smem + s * S::kStageBytes, s);
    cp_async_commit();
  }

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();          // stage s has landed ...
    __syncthreads();                       // ... for every thread, and
                                           // stage s - 1 is consumed
    const int next = s + kStages - 1;
    if (next < steps) {
      plan.issue(smem + (next % kStages) * S::kStageBytes, next);
    }
    cp_async_commit();
    const unsigned char* st = smem + (s % kStages) * S::kStageBytes;
#pragma unroll
    for (int j = 0; j < S::kSteps; ++j) {
      k32_step<T, MT>(st, 32 * (kwarp + S::kKWarps * j), wl, al, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                         // the ring is free

  // the warps' partial tiles [kwarp][MT][kBN] (rows kRedStride apart):
  // accumulator e of MMA tile i, column tile nt is output column
  // 64 group + 8g + 2i + (e >> 1), row nt * 8 + 2t + (e & 1)
  Acc* red = reinterpret_cast<Acc*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Acc v;
        if constexpr (sizeof(T) == 2) {
          v = (static_cast<long long>(acc[0][i][nt][e]) << 16) +
              (static_cast<long long>(acc[1][i][nt][e]) << 8) +
              static_cast<long long>(acc[2][i][nt][e]);
        } else {
          v = acc[0][i][nt][e];
        }
        const int m = nt * 8 + 2 * t + (e & 1);
        red[(kwarp * MT + m) * S::kRedStride + 64 * group + 8 * g + 2 * i +
            (e >> 1)] = v;
      }
    }
  }
  __syncthreads();

  Acc total[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    total[j] = 0;
#pragma unroll
    for (int w = 0; w < S::kKWarps; ++w) {
      total[j] += red[(w * MT + mr + kRowStep * j) * S::kRedStride + c];
    }
  }
  auto store = [&](int j, Acc v) {
    const int row = m0 + mr + kRowStep * j;
    if (row >= M || cn >= N) return;
    const size_t o = static_cast<size_t>(row) * N + cn;
    if constexpr (kRaw) {
      // the low 32 bits: the wrapping int32 sum
      static_cast<int*>(out_)[o] = static_cast<int>(static_cast<unsigned>(v));
    } else {
      const float f = __fmul_rn(__ll2float_rn(v), sc);
      static_cast<float*>(out_)[o] = apply_af(f, af, cp, lv_n);
    }
  };
  if (gridDim.y == 1) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) store(j, total[j]);
    return;
  }
  // split K: add the tile into the workspace, then let the last block of
  // the tile apply the epilogue
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int row = m0 + mr + kRowStep * j;
    if (row < M && cn < N && total[j] != 0) {
      Acc* w = ws + static_cast<size_t>(row) * N + cn;
      if constexpr (sizeof(T) == 2) {
        atomicAdd(reinterpret_cast<unsigned long long*>(w),
                  static_cast<unsigned long long>(total[j]));
      } else {
        atomicAdd(w, total[j]);
      }
    }
  }
  // the block's adds, ordered by the barrier, are released to the GPU by
  // one thread's fence before its semaphore add (and acquired by the last
  // block's), as CUTLASS's semaphore does
  __syncthreads();
  if (tid == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    const unsigned prev =
        atomicAdd(&counters[blockIdx.z * gridDim.x + blockIdx.x], 1u);
    is_last = prev == gridDim.y - 1;
    if (is_last) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
  if (!is_last) return;
  // every load before the first store: one round trip to the L2
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int row = m0 + mr + kRowStep * j;
    total[j] = (row < M && cn < N)
        ? __ldcg(ws + static_cast<size_t>(row) * N + cn) : Acc(0);
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) store(j, total[j]);
}

template <typename T, int MT, bool kRaw>
cudaError_t launch(const T* a, const T* b, const float* scale, void* out,
                   typename Shape<T, MT>::Acc* ws, unsigned* counters, int M,
                   int K, int N, int kps, int vec, int af, int lv_n,
                   const CordicParams& cp, cudaStream_t stream) {
  constexpr int kSmem = Shape<T, MT>::kSmem;
  constexpr int kBN = Shape<T, MT>::kBN;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fxp_gemm_tc_kernel<T, MT, kRaw>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + kBN - 1) / kBN, (K + kps - 1) / kps, (M + MT - 1) / MT);
  fxp_gemm_tc_kernel<T, MT, kRaw><<<grid, kThreads, kSmem, stream>>>(
      a, b, scale, out, ws, counters, M, K, N, kps, vec, af, lv_n, cp);
  return cudaGetLastError();
}

// Row tiles of 8, 16 or (int8 codes) 32 activation rows: one to four MMA
// column tiles share each weight fragment.
template <typename T, bool kRaw>
int dispatch(const T* a, const T* b, const float* scale, void* out,
             typename Shape<T, 8>::Acc* ws, unsigned* counters, int M, int K,
             int N, int kps, int vec, int af, int lv_n, const CordicParams* cp,
             void* stream) {
  constexpr int kMaxMT = sizeof(T) == 1 ? 32 : 16;
  if (M <= 0 || N <= 0 || K <= 0 || kps <= 0 || kps % kBK != 0 ||
      kps > kMaxKSplitWide || (K + kps - 1) / kps > 65535 ||
      (M + kMaxMT - 1) / kMaxMT > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 8) {
    return static_cast<int>(launch<T, 8, kRaw>(
        a, b, scale, out, ws, counters, M, K, N, kps, vec, af, lv_n, *cp, s));
  }
  if constexpr (kMaxMT == 32) {
    if (M > 16) {
      return static_cast<int>(launch<T, 32, kRaw>(
          a, b, scale, out, ws, counters, M, K, N, kps, vec, af, lv_n, *cp,
          s));
    }
  }
  return static_cast<int>(launch<T, 16, kRaw>(
      a, b, scale, out, ws, counters, M, K, N, kps, vec, af, lv_n, *cp, s));
}

}  // namespace tc

// Raw products of int32 codes: a 32 x 32 output tile per block, A and B
// staged in shared memory 32 k rows at a time, each thread four rows of
// one column. Unsigned arithmetic wraps as the reference's int32 dot
// does; inside the caller's bound nothing wraps.
constexpr int kWideTile = 32;

__global__ void __launch_bounds__(kThreads)
gemm_codes_wide_kernel(const int32_t* __restrict__ A,
                       const int32_t* __restrict__ B, int* __restrict__ out,
                       int M, int K, int N) {
  __shared__ int a_t[kWideTile][kWideTile + 1];     // [m][k]
  __shared__ int b_t[kWideTile][kWideTile + 1];     // [k][n]
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int m0 = blockIdx.y * kWideTile;
  const int n0 = blockIdx.x * kWideTile;
  constexpr int kRows = kWideTile / kWarps;
  unsigned acc[kRows] = {};
  for (int k0 = 0; k0 < K; k0 += kWideTile) {
    for (int i = ty; i < kWideTile; i += kWarps) {
      const int m = m0 + i;
      const int k = k0 + tx;
      a_t[i][tx] = (m < M && k < K) ? A[static_cast<size_t>(m) * K + k] : 0;
      const int kk = k0 + i;
      const int nn = n0 + tx;
      b_t[i][tx] = (kk < K && nn < N) ? B[static_cast<size_t>(kk) * N + nn]
                                      : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kWideTile; ++kk) {
      const unsigned bv = static_cast<unsigned>(b_t[kk][tx]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r] += static_cast<unsigned>(a_t[ty + kWarps * r][kk]) * bv;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int m = m0 + ty + kWarps * r;
    if (m < M && n0 + tx < N) {
      out[static_cast<size_t>(m) * N + n0 + tx] = static_cast<int>(acc[r]);
    }
  }
}

const CordicParams kNoCordic = {};

}  // namespace

// E products in one launch: a [E, M, K], b [E, K, N], scale [E, N],
// out [E, M, N]; ws [E, M, N] and one counter per (expert, tile), zeroed.
extern "C" int fxp_gemm_fused_batched(const int8_t* a, const int8_t* b,
                                      const float* scale, float* out, int* ws,
                                      unsigned* counters, int E, int M, int K,
                                      int N, int kps, int vec, int af,
                                      int lv_n, const CordicParams* cp,
                                      void* stream) {
  return dispatch<kExpertBank, false>(a, b, scale, out, ws, counters, E, M, K,
                                      N, N, kps, vec, af, lv_n, cp, stream);
}

extern "C" int fxp_gemm_fused(const int8_t* a, const int8_t* b,
                              const float* scale, float* out, int* ws,
                              unsigned* counters, int M, int K, int N, int kps,
                              int vec, int af, int lv_n,
                              const CordicParams* cp, void* stream) {
  return dispatch<kDense, false>(a, b, scale, out, ws, counters, 1, M, K, N,
                                 N, kps, vec, af, lv_n, cp, stream);
}

// Packed FxP4 weights: b holds nibble bytes [K, ldb] (the int32 words of
// core.simd.pack seen as bytes), N <= 2 * ldb output columns.
extern "C" int fxp_gemm_fused_packed(const int8_t* a, const int8_t* b,
                                     const float* scale, float* out, int* ws,
                                     unsigned* counters, int M, int K, int N,
                                     int ldb, int kps, int vec, int af,
                                     int lv_n, const CordicParams* cp,
                                     void* stream) {
  return dispatch<kPackedFxP4, false>(a, b, scale, out, ws, counters, 1, M, K,
                                      N, ldb, kps, vec, af, lv_n, cp, stream);
}

// Packed FxP4 expert banks: b holds nibble bytes [E, K, ldb], N <= 2 * ldb.
extern "C" int fxp_gemm_fused_batched_packed(const int8_t* a, const int8_t* b,
                                             const float* scale, float* out,
                                             int* ws, unsigned* counters,
                                             int E, int M, int K, int N,
                                             int ldb, int kps, int vec, int af,
                                             int lv_n, const CordicParams* cp,
                                             void* stream) {
  return dispatch<kPackedBank, false>(a, b, scale, out, ws, counters, E, M, K,
                                      N, ldb, kps, vec, af, lv_n, cp, stream);
}

// Codes wider than 8 bits on the tensor-core core: int16 a [M, K],
// b [K, N]; kps a multiple of 128, at most 32768; when K is split
// (kps < K) ws int64 [M, N] and one counter per tile, zeroed; `vec` bit
// 0 / 1: b's / a's rows are 16-byte aligned.
extern "C" int fxp_gemm_fused_wide(const int16_t* a, const int16_t* b,
                                   const float* scale, float* out,
                                   long long* ws, unsigned* counters, int M,
                                   int K, int N, int kps, int vec, int af,
                                   int lv_n, const CordicParams* cp,
                                   void* stream) {
  return tc::dispatch<int16_t, false>(a, b, scale, out, ws, counters, M, K, N,
                                      kps, vec, af, lv_n, cp, stream);
}

// Raw int32 products, no epilogue: int8 codes b [K, N] on the tensor-core
// core (ws int32, kps and `vec` as for the wide mode), or with packed = 1
// nibble bytes b [K, ldb] on the __dp4a walk.
extern "C" int fxp_gemm_codes_int8(const int8_t* a, const int8_t* b, int* out,
                                   int* ws, unsigned* counters, int M, int K,
                                   int N, int ldb, int packed, int kps,
                                   int vec, void* stream) {
  return packed
      ? dispatch<kPackedFxP4, true>(a, b, nullptr, out, ws, counters, 1, M, K,
                                    N, ldb, kps, vec, 0, 0, &kNoCordic, stream)
      : tc::dispatch<int8_t, true>(a, b, nullptr, out, ws, counters, M, K, N,
                                   kps, vec, 0, 0, &kNoCordic, stream);
}

// Raw products of int16 codes on the tensor-core core: the low 32 bits of
// the exact sum (ws int64, as for the wide mode).
extern "C" int fxp_gemm_codes_int16(const int16_t* a, const int16_t* b,
                                    int* out, long long* ws,
                                    unsigned* counters, int M, int K, int N,
                                    int kps, int vec, void* stream) {
  return tc::dispatch<int16_t, true>(a, b, nullptr, out, ws, counters, M, K,
                                     N, kps, vec, 0, 0, &kNoCordic, stream);
}

// Raw int32 products of int32 codes.
extern "C" int fxp_gemm_codes_int32(const int32_t* a, const int32_t* b,
                                    int* out, int M, int K, int N,
                                    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + kWideTile - 1) / kWideTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((N + kWideTile - 1) / kWideTile, (M + kWideTile - 1) / kWideTile);
  gemm_codes_wide_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a, b, out, M,
                                                                K, N);
  return static_cast<int>(cudaGetLastError());
}
