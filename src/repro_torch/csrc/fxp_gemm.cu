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
// Not yet: wgmma / mma.sync tensor cores and TMA (they need a k-major
// weight layout or an in-shared-memory transpose), packed FxP4 weights and
// >8-bit codes.
#include <cuda_runtime.h>

#include <cstdint>

#include "cordic.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 128;       // 32 lanes x 4 columns
constexpr int kMaxKSplit = 1024;   // K rows per block (A slice in smem)

template <int MT, bool kExperts>
__global__ void __launch_bounds__(kThreads)
fxp_gemm_fused_kernel(const int8_t* __restrict__ A,
                      const int8_t* __restrict__ B,
                      const float* __restrict__ scale,
                      float* __restrict__ out, int* __restrict__ ws,
                      unsigned* __restrict__ counters, int M, int K, int N,
                      int kps, int vec, int af, int lv_n, CordicParams cp) {
  __shared__ int a_s[MT][kMaxKSplit / 4];
  __shared__ int tile[MT][kBlockN];
  __shared__ int is_last;
  __shared__ unsigned live;                  // bit m: row m0+m has a code

  int m0 = blockIdx.z * MT;
  if constexpr (kExperts) {
    // blockIdx.z = expert * (row tiles) + row tile
    const int m_tiles = (M + MT - 1) / MT;
    const int expert = blockIdx.z / m_tiles;
    A += static_cast<size_t>(expert) * M * K;
    B += static_cast<size_t>(expert) * K * N;
    scale += static_cast<size_t>(expert) * N;
    out += static_cast<size_t>(expert) * M * N;
    ws += static_cast<size_t>(expert) * M * N;
    m0 = (blockIdx.z - expert * m_tiles) * MT;
  }
  const int n0 = blockIdx.x * kBlockN;
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
  for (int i = tid; i < MT * kBlockN; i += kThreads) {
    tile[i / kBlockN][i % kBlockN] = 0;
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

  int acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;
  }

  const int n = n0 + 4 * lane;
  for (int g = g0; g < kw; g += kWarps) {
    const int kb = k0 + 4 * g;
    unsigned r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kb + j;
      unsigned word = 0;
      if (k < k1 && n < N) {
        const int8_t* row = B + static_cast<size_t>(k) * N;
        if (vec) {
          word = __ldg(reinterpret_cast<const unsigned*>(row + n));
        } else {
          for (int c = 0; c < 4; ++c) {
            if (n + c < N) {
              word |= static_cast<unsigned>(static_cast<uint8_t>(row[n + c]))
                      << (8 * c);
            }
          }
        }
      }
      r[j] = word;
    }
    // 4x4 byte transpose: column c's word holds rows kb..kb+3 of column n+c
    const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
    const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
    const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
    const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
    const int col[4] = {static_cast<int>(__byte_perm(t0, t2, 0x5410)),
                        static_cast<int>(__byte_perm(t0, t2, 0x7632)),
                        static_cast<int>(__byte_perm(t1, t3, 0x5410)),
                        static_cast<int>(__byte_perm(t1, t3, 0x7632))};
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (!kExperts || (live_rows & (1u << m))) {    // uniform block-wide
        const int a = a_s[m][g];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = __dp4a(col[c], a, acc[m][c]);
      }
    }
  }

  // reduce the eight warps' partial sums in shared memory (exact)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (acc[m][c] != 0) atomicAdd(&tile[m][4 * lane + c], acc[m][c]);
    }
  }
  __syncthreads();

  const bool split = gridDim.y > 1;
  if (split) {
    // add this block's partial tile into the workspace, then let the last
    // block of the tile apply the epilogue
    for (int i = tid; i < MT * kBlockN; i += kThreads) {
      const int m = i / kBlockN;
      const int c = i % kBlockN;
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

  for (int i = tid; i < MT * kBlockN; i += kThreads) {
    const int m = i / kBlockN;
    const int c = i % kBlockN;
    const int row = m0 + m;
    const int cn = n0 + c;
    if (row < M && cn < N) {
      const size_t o = static_cast<size_t>(row) * N + cn;
      const int total = split ? __ldcg(&ws[o]) : tile[m][c];
      const float v = __fmul_rn(static_cast<float>(total), scale[cn]);
      out[o] = apply_af(v, af, cp, lv_n);
    }
  }
}

template <int MT, bool kExperts>
cudaError_t launch(const int8_t* a, const int8_t* b, const float* scale,
                   float* out, int* ws, unsigned* counters, int E, int M,
                   int K, int N, int kps, int vec, int af, int lv_n,
                   const CordicParams& cp, cudaStream_t stream) {
  const int splits = (K + kps - 1) / kps;
  dim3 grid((N + kBlockN - 1) / kBlockN, splits, E * ((M + MT - 1) / MT));
  fxp_gemm_fused_kernel<MT, kExperts><<<grid, kThreads, 0, stream>>>(
      a, b, scale, out, ws, counters, M, K, N, kps, vec, af, lv_n, cp);
  return cudaGetLastError();
}

template <bool kExperts>
int dispatch(const int8_t* a, const int8_t* b, const float* scale, float* out,
             int* ws, unsigned* counters, int E, int M, int K, int N, int kps,
             int vec, int af, int lv_n, const CordicParams* cp,
             void* stream) {
  const int max_mt = 16;
  if (E <= 0 || M <= 0 || N <= 0 || K <= 0 || kps <= 0 ||
      kps > kMaxKSplit || kps % 4 != 0 ||
      static_cast<long long>(E) * ((M + max_mt - 1) / max_mt) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 4) {
    return static_cast<int>(launch<4, kExperts>(
        a, b, scale, out, ws, counters, E, M, K, N, kps, vec, af, lv_n, *cp,
        s));
  }
  if (M <= 8) {
    return static_cast<int>(launch<8, kExperts>(
        a, b, scale, out, ws, counters, E, M, K, N, kps, vec, af, lv_n, *cp,
        s));
  }
  return static_cast<int>(launch<16, kExperts>(
      a, b, scale, out, ws, counters, E, M, K, N, kps, vec, af, lv_n, *cp, s));
}

}  // namespace

// E products in one launch: a [E, M, K], b [E, K, N], scale [E, N],
// out [E, M, N]; ws [E, M, N] and one counter per (expert, tile), zeroed.
extern "C" int fxp_gemm_fused_batched(const int8_t* a, const int8_t* b,
                                      const float* scale, float* out, int* ws,
                                      unsigned* counters, int E, int M, int K,
                                      int N, int kps, int vec, int af,
                                      int lv_n, const CordicParams* cp,
                                      void* stream) {
  return dispatch<true>(a, b, scale, out, ws, counters, E, M, K, N, kps, vec,
                        af, lv_n, cp, stream);
}

extern "C" int fxp_gemm_fused(const int8_t* a, const int8_t* b,
                              const float* scale, float* out, int* ws,
                              unsigned* counters, int M, int K, int N, int kps,
                              int vec, int af, int lv_n,
                              const CordicParams* cp, void* stream) {
  return dispatch<false>(a, b, scale, out, ws, counters, 1, M, K, N, kps, vec,
                         af, lv_n, cp, stream);
}
