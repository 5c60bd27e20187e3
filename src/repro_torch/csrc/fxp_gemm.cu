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
// Codes wider than 8 bits (FxP12/16 in int16; fxp_gemm_wide_kernel, its
// own kernel, so the int8 body stays as it is): a product of two int16
// codes is at most 2^30, exact in int32, but a sum of two is not. The
// kernel accumulates in f64 instead, which holds every partial sum of
// integer products exactly while K * 2^30 < 2^53 (K up to 8M): every
// order gives the exact integer sum, which is rounded once to f32
// (round to nearest) before the scale. The plain version computes the
// same exact sum, so the two agree bit for bit, and under the reference's
// wide_exact bound (K * qmax^2 < 2^31, its int32 accumulator) they equal
// the reference bit for bit too. Past that bound the reference sums in
// f32 in XLA's order, within one f32 rounding per step of the exact sum.
// Each lane loads 4 int16 columns (8 bytes) of a row, converts them once
// and runs MT f64 FMAs per column; K is split across blocks as for int8,
// with an f64 workspace (atomic adds of integers below 2^53 are exact in
// any order).
//
// Raw code GEMMs (src/repro/kernels/fxp_gemm/fxp_gemm.py, fxp_gemm_pallas
// and fxp4_gemm_packed_pallas) are the same walk without the epilogue:
// the int32 sums are written as they are. Codes wider than 8 bits take a
// plain tiled int32 multiply-add (gemm_codes_wide_kernel); as in the
// reference, the caller owns the overflow-free bound K * qmax^2 < 2^31.
// Not yet: wgmma / mma.sync tensor cores and TMA (they need a k-major
// weight layout or an in-shared-memory transpose).
#include <cuda_runtime.h>

#include <cstdint>

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

// Fused GEMM of codes wider than 8 bits (int16): A [M, K], B [K, N],
// exact f64 sums, the same epilogue. Tiles of at most 8 rows; the staged
// A slice holds its codes as doubles.
constexpr int kMaxKSplitWide = 512;

template <int MT>
__global__ void __launch_bounds__(kThreads)
fxp_gemm_wide_kernel(const int16_t* __restrict__ A,
                     const int16_t* __restrict__ B,
                     const float* __restrict__ scale,
                     float* __restrict__ out, double* __restrict__ ws,
                     unsigned* __restrict__ counters, int M, int K, int N,
                     int kps, int vec, int af, int lv_n, CordicParams cp) {
  __shared__ double a_s[MT][kMaxKSplitWide];
  __shared__ double tile[MT][kBlockN];
  __shared__ int is_last;

  const int m0 = blockIdx.z * MT;
  const int n0 = blockIdx.x * kBlockN;
  const int k0 = blockIdx.y * kps;
  const int k1 = min(K, k0 + kps);
  const int kn = k1 - k0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < MT * kn; i += kThreads) {
    const int m = i / kn;
    const int k = i - m * kn;
    a_s[m][k] = m0 + m < M
        ? static_cast<double>(A[static_cast<size_t>(m0 + m) * K + k0 + k])
        : 0.0;
  }
  for (int i = tid; i < MT * kBlockN; i += kThreads) {
    tile[i / kBlockN][i % kBlockN] = 0.0;
  }
  __syncthreads();

  double acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.0;
  }

  // each warp takes four consecutive k rows per step, eight warps apart
  const int n = n0 + 4 * lane;
  for (int kb = k0 + 4 * warp; kb < k1; kb += 4 * kWarps) {
    double w[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kb + j;
      int16_t v[4] = {0, 0, 0, 0};
      if (k < k1 && n < N) {
        const int16_t* row = B + static_cast<size_t>(k) * N + n;
        if (vec) {
          const uint2 word = __ldg(reinterpret_cast<const uint2*>(row));
          v[0] = static_cast<int16_t>(word.x & 0xFFFFu);
          v[1] = static_cast<int16_t>(word.x >> 16);
          v[2] = static_cast<int16_t>(word.y & 0xFFFFu);
          v[3] = static_cast<int16_t>(word.y >> 16);
        } else {
          for (int c = 0; c < 4; ++c) {
            if (n + c < N) v[c] = row[c];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) w[j][c] = static_cast<double>(v[c]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kb + j < k1) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const double a = a_s[m][kb + j - k0];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[m][c] = __fma_rn(a, w[j][c], acc[m][c]);   // exact
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (acc[m][c] != 0.0) atomicAdd(&tile[m][4 * lane + c], acc[m][c]);
    }
  }
  __syncthreads();

  const bool split = gridDim.y > 1;
  if (split) {
    for (int i = tid; i < MT * kBlockN; i += kThreads) {
      const int m = i / kBlockN;
      const int c = i % kBlockN;
      if (m0 + m < M && n0 + c < N && tile[m][c] != 0.0) {
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

  for (int i = tid; i < MT * kBlockN; i += kThreads) {
    const int m = i / kBlockN;
    const int c = i % kBlockN;
    const int row = m0 + m;
    const int cn = n0 + c;
    if (row < M && cn < N) {
      const size_t o = static_cast<size_t>(row) * N + cn;
      const double total = split ? __ldcg(&ws[o]) : tile[m][c];
      const float v = __fmul_rn(__double2float_rn(total), scale[cn]);
      out[o] = apply_af(v, af, cp, lv_n);
    }
  }
}

template <int MT>
cudaError_t launch_wide(const int16_t* a, const int16_t* b,
                        const float* scale, float* out, double* ws,
                        unsigned* counters, int M, int K, int N, int kps,
                        int vec, int af, int lv_n, const CordicParams& cp,
                        cudaStream_t stream) {
  dim3 grid((N + kBlockN - 1) / kBlockN, (K + kps - 1) / kps,
            (M + MT - 1) / MT);
  fxp_gemm_wide_kernel<MT><<<grid, kThreads, 0, stream>>>(
      a, b, scale, out, ws, counters, M, K, N, kps, vec, af, lv_n, cp);
  return cudaGetLastError();
}

// Raw products of codes wider than 8 bits: a 32 x 32 output tile per
// block, A and B staged in shared memory 32 k rows at a time, each thread
// four rows of one column. Unsigned arithmetic wraps as the reference's
// int32 dot does; inside the caller's bound nothing wraps.
constexpr int kWideTile = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_codes_wide_kernel(const T* __restrict__ A, const T* __restrict__ B,
                       int* __restrict__ out, int M, int K, int N) {
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
      a_t[i][tx] = (m < M && k < K)
          ? static_cast<int>(A[static_cast<size_t>(m) * K + k]) : 0;
      const int kk = k0 + i;
      const int nn = n0 + tx;
      b_t[i][tx] = (kk < K && nn < N)
          ? static_cast<int>(B[static_cast<size_t>(kk) * N + nn]) : 0;
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

// Codes wider than 8 bits: int16 a [M, K], b [K, N]; ws f64 [M, N] and one
// counter per tile, zeroed, when K is split (kps < K).
extern "C" int fxp_gemm_fused_wide(const int16_t* a, const int16_t* b,
                                   const float* scale, float* out, double* ws,
                                   unsigned* counters, int M, int K, int N,
                                   int kps, int vec, int af, int lv_n,
                                   const CordicParams* cp, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || kps <= 0 || kps > kMaxKSplitWide ||
      (M + 7) / 8 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 4) {
    return static_cast<int>(launch_wide<4>(a, b, scale, out, ws, counters, M,
                                           K, N, kps, vec, af, lv_n, *cp, s));
  }
  return static_cast<int>(launch_wide<8>(a, b, scale, out, ws, counters, M, K,
                                         N, kps, vec, af, lv_n, *cp, s));
}

// Raw int32 products, no epilogue: int8 codes b [K, N], or with packed = 1
// nibble bytes b [K, ldb].
extern "C" int fxp_gemm_codes_int8(const int8_t* a, const int8_t* b, int* out,
                                   int* ws, unsigned* counters, int M, int K,
                                   int N, int ldb, int packed, int kps,
                                   int vec, void* stream) {
  return packed
      ? dispatch<kPackedFxP4, true>(a, b, nullptr, out, ws, counters, 1, M, K,
                                    N, ldb, kps, vec, 0, 0, &kNoCordic, stream)
      : dispatch<kDense, true>(a, b, nullptr, out, ws, counters, 1, M, K, N,
                               N, kps, vec, 0, 0, &kNoCordic, stream);
}

// Raw int32 products of int16 (elem_bytes 2) or int32 (4) codes.
extern "C" int fxp_gemm_codes_wide(const void* a, const void* b, int* out,
                                   int M, int K, int N, int elem_bytes,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (elem_bytes != 2 && elem_bytes != 4) ||
      (M + kWideTile - 1) / kWideTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + kWideTile - 1) / kWideTile, (M + kWideTile - 1) / kWideTile);
  if (elem_bytes == 2) {
    gemm_codes_wide_kernel<int16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const int16_t*>(a), static_cast<const int16_t*>(b), out,
        M, K, N);
  } else {
    gemm_codes_wide_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b), out,
        M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
