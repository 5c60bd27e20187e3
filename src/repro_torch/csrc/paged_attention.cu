// paged_attention_float and paged_attention_int — one-query GQA decode
// attention read straight off the paged KV pool, written for Hopper
// (sm_90a). The integer body is described above its kernel below.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py,
// paged_attention_float_pallas (_float_body with _dequant_kernel for int8
// pools, _float_kernel for bf16 pools). For one row b and one KV head h:
//   * walk the row's block table; table entries >= NB (the unallocated
//     sentinel) stage exact zeros;
//   * dequantize int8 codes x per-position scale, snapped to bf16
//     (__float2bfloat16_rn(code * scale)), or read bf16 pool values;
//   * scores s = (q . k) / sqrt(hd), masked to -1e30 where
//     pos > query position or pos >= the row's valid length;
//   * full-row max, exp (exact, or the CORDIC hr_exp), sum, AV and the
//     divide (exact, or the CORDIC lv_div with the operands scaled into
//     [-1, 1]) — the same full-row semantics the TPU kernel keeps for
//     exactness, not a flash-style running rescale.
//
// What bounds it: each allocated block's codes (K and V) and scales are
// read once; the arithmetic is ~4 operations per byte, so the kernel is
// bound by memory (bytes over 3.35 TB/s) — and at small batch by how few
// blocks are in flight.
//
// What the design does about it: one block per (row, KV head) reads each
// K/V position once for all g query heads of the group (GQA sharing).
// Scores: a thread per position reads its K row with 16-byte loads and
// keeps the g dot products in registers (q broadcast from shared memory);
// masked positions skip the dot. AV: a warp per position, each lane four
// consecutive head dims in one load, g x 4 sums in registers, warps
// combined once in a fixed order. The score row stays on chip in shared
// memory (or in a global scratch row when MB*bs*g*4 bytes do not fit), so
// exp, sum and AV read no score from device memory. A TPU grid carries
// state from one block-table step to the next; here the walk is a loop
// inside the block. Not yet: splitting a long row across blocks (the
// parallelism at small batch is only B*KV blocks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cordic.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;            // query heads per KV head
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float dequant(int8_t code, float scale) {
  return __bfloat162float(
      __float2bfloat16_rn(__fmul_rn(static_cast<float>(code), scale)));
}

// 16 bytes of a K row -> float values (16 int8 codes or 8 bf16 values)
template <typename PoolT>
struct Vec16;

template <>
struct Vec16<int8_t> {
  static constexpr int kN = 16;
  __device__ static void load(const int8_t* p, float scale, float* out) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
    for (int i = 0; i < kN; ++i) out[i] = dequant(c[i], scale);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float, float* out) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    const __nv_bfloat16* c = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
    for (int i = 0; i < kN; ++i) out[i] = __bfloat162float(c[i]);
  }
};

// four consecutive head dims of a V row -> floats
__device__ __forceinline__ void load4(const int8_t* p, float scale,
                                      float* out) {
  const char4 w = *reinterpret_cast<const char4*>(p);
  out[0] = dequant(w.x, scale);
  out[1] = dequant(w.y, scale);
  out[2] = dequant(w.z, scale);
  out[3] = dequant(w.w, scale);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float,
                                      float* out) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* c = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __bfloat162float(c[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// block-wide reduction of one value per head; `red` holds kWarps * kMaxG
template <bool kMax>
__device__ void block_reduce(const float (&v)[kMaxG], int g, float* red,
                             float* res) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    if (gi < g) {
      const float w = kMax ? warp_max(v[gi]) : warp_sum(v[gi]);
      if (lane == 0) red[warp * kMaxG + gi] = w;
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < g) {
    float acc = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) {
      const float x = red[w * kMaxG + threadIdx.x];
      acc = kMax ? fmaxf(acc, x) : __fadd_rn(acc, x);
    }
    res[threadIdx.x] = acc;
  }
  __syncthreads();
}

template <typename PoolT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const PoolT* __restrict__ k_pool,
                       const PoolT* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ meta,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ scratch, int NB, int bs, int KV,
                       int g, int hd, int MB, float sm_scale, int cordic,
                       int lv_n, CordicParams cp) {
  constexpr bool kQuant = sizeof(PoolT) == 1;
  extern __shared__ float smem[];
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x - b * KV;
  const int S = MB * bs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* q_s = smem;                          // [g, hd]
  float* o_s = q_s + g * hd;                  // [kWarps, g, hd]
  float* red = o_s + kWarps * g * hd;         // [kWarps, kMaxG]
  float* m_s = red + kWarps * kMaxG;          // [kMaxG] row max
  float* den_s = m_s + kMaxG;                 // [kMaxG] row sum
  float* amax_s = den_s + kMaxG;              // [kMaxG] max |o|
  float* s_s = scratch != nullptr
      ? scratch + static_cast<size_t>(blockIdx.x) * g * S
      : amax_s + kMaxG;                       // [g, S] scores, then p

  const int qpos = meta[b * 3 + 2];
  const int kvv = meta[b * 3 + 1];
  const int* tbl = tables + static_cast<size_t>(b) * MB;
  const size_t q_base = (static_cast<size_t>(b) * KV + h) * g * hd;
  for (int i = tid; i < g * hd; i += kThreads) {
    q_s[i] = __bfloat162float(q[q_base + i]);
  }
  __syncthreads();

  // 1) scores: a thread per position, the g dot products in registers;
  //    masked positions are -1e30 whatever their dot, so they skip it
  for (int p = tid; p < S; p += kThreads) {
    float part[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) part[gi] = 0.f;
    const bool valid = p <= qpos && p < kvv;
    const int blk = tbl[p / bs];
    if (valid && blk < NB) {
      const size_t pos = (static_cast<size_t>(blk) * bs + p % bs) * KV + h;
      const PoolT* row = k_pool + pos * hd;
      const float sc = kQuant ? k_scale[pos] : 0.f;
      for (int d0 = 0; d0 < hd; d0 += Vec16<PoolT>::kN) {
        float kv[Vec16<PoolT>::kN];
        Vec16<PoolT>::load(row + d0, sc, kv);
#pragma unroll
        for (int i = 0; i < Vec16<PoolT>::kN; ++i) {
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi) {
            if (gi < g) {
              part[gi] = __fadd_rn(part[gi],
                                   __fmul_rn(q_s[gi * hd + d0 + i], kv[i]));
            }
          }
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        s_s[gi * S + p] = valid ? __fmul_rn(part[gi], sm_scale) : kMasked;
      }
    }
  }
  __syncthreads();

  // 2) full-row max per head
  float v[kMaxG];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) v[gi] = kMasked;
  for (int p = tid; p < S; p += kThreads) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) v[gi] = fmaxf(v[gi], s_s[gi * S + p]);
    }
  }
  block_reduce<true>(v, g, red, m_s);

  // 3) p = exp(s - max) in place, and the row sum
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) v[gi] = 0.f;
  for (int p = tid; p < S; p += kThreads) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        const float z = __fsub_rn(s_s[gi * S + p], m_s[gi]);
        const float e = cordic ? hr_exp(z, cp) : expf(z);
        s_s[gi * S + p] = e;
        v[gi] = __fadd_rn(v[gi], e);
      }
    }
  }
  block_reduce<false>(v, g, red, den_s);

  // 4) AV: a warp per position, lanes over 4-dim groups, sums in registers;
  //    sentinel blocks hold V = 0 exactly and are skipped
  for (int d0 = 4 * lane; d0 < hd; d0 += 128) {
    float acc[kMaxG][4];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[gi][i] = 0.f;
    }
#pragma unroll 4
    for (int p = warp; p < S; p += kWarps) {
      const int blk = tbl[p / bs];
      if (blk >= NB) continue;
      const size_t pos = (static_cast<size_t>(blk) * bs + p % bs) * KV + h;
      float val[4];
      load4(v_pool + pos * hd + d0, kQuant ? v_scale[pos] : 0.f, val);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < g) {
          const float pr = s_s[gi * S + p];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[gi][i] = __fadd_rn(acc[gi][i], __fmul_rn(pr, val[i]));
          }
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o_s[(warp * g + gi) * hd + d0 + i] = acc[gi][i];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < g * hd; i += kThreads) {
    float acc = o_s[i];
    for (int w = 1; w < kWarps; ++w) acc = __fadd_rn(acc, o_s[w * g * hd + i]);
    o_s[i] = acc;
  }
  __syncthreads();

  // 5) the divide: exact, or LV CORDIC on operands scaled into [-1, 1]
  if (cordic) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) v[gi] = 0.f;
    for (int i = tid; i < g * hd; i += kThreads) {
      const int gi = i / hd;
#pragma unroll
      for (int gj = 0; gj < kMaxG; ++gj) {
        if (gj == gi) v[gj] = fmaxf(v[gj], fabsf(o_s[i]));
      }
    }
    block_reduce<true>(v, g, red, amax_s);
  }
  const size_t out_base = (static_cast<size_t>(b) * KV + h) * g * hd;
  for (int i = tid; i < g * hd; i += kThreads) {
    const int gi = i / hd;
    const float den = den_s[gi];
    float res;
    if (cordic) {
      const float sc = __fadd_rn(fmaxf(amax_s[gi], den), 1e-9f);
      res = lv_div(__fdiv_rn(o_s[i], sc), __fdiv_rn(den, sc), lv_n);
    } else {
      res = __fdiv_rn(o_s[i], den);
    }
    out[out_base + i] = __float2bfloat16_rn(res);
  }
}

size_t smem_bytes(int g, int hd, int S, bool with_scores) {
  return (static_cast<size_t>(g) * hd * (1 + kWarps) + kWarps * kMaxG
          + 3 * kMaxG + (with_scores ? static_cast<size_t>(g) * S : 0))
         * sizeof(float);
}

template <typename PoolT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* meta, void* out,
                   float* scratch, int B, int NB, int bs, int KV, int g,
                   int hd, int MB, float sm_scale, int cordic, int lv_n,
                   const CordicParams& cp, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, hd, MB * bs, scratch == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<PoolT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  paged_attention_kernel<PoolT><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const PoolT*>(k_pool), static_cast<const PoolT*>(v_pool),
      k_scale, v_scale, tables, meta, static_cast<__nv_bfloat16*>(out),
      scratch, NB, bs, KV, g, hd, MB, sm_scale, cordic, lv_n, cp);
  return cudaGetLastError();
}


// paged_attention_int — fully integer decode attention on the int8 pool.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py,
// paged_attention_int_pallas (body _int_kernel). For one row b and one KV
// head h, with q codes [g, hd] and their scales [g] quantized by the caller
// (q / sqrt(hd), per head over hd):
//   * s_int = q_codes . k_codes over hd with __dp4a (exact int32);
//   * s = (float(s_int) * sq) * ks, the reference's order; positions above
//     the query position or at/after the valid length are -1e30; sentinel
//     table entries read zero codes and zero scales;
//   * the exact softmax: row max, expf(s - max), row sum, IEEE divide;
//   * pv = p * vs; per head, scale = max(max |pv|, 1e-12) / qmax and codes
//     rint(pv / scale) clipped to [qmin, qmax] (a true division, as
//     core.fxp.quantize divides);
//   * o = sum over positions of pv codes x v codes (exact int32), times the
//     scale, rounded to bf16.
// The integer dots are exact in any order; only the softmax's sum order and
// expf differ from the plain version, and a p.v code that flips with them
// moves the output by one v step times the row scale.
//
// What bounds it: the int8 K and V codes and their scales, read once per
// allocated position (~2 operations per byte): memory, and at small batch
// how few blocks are in flight (B * KV). The design is the float body's:
// one block per (row, KV head) shares each K/V row among the g query heads,
// a thread per position for the scores (16-byte K loads, g __dp4a sums in
// registers), the score row on chip (or in a global scratch row when too
// wide), a warp per position for the AV sums with lanes over head dims.
__global__ void __launch_bounds__(kThreads)
paged_attention_int_kernel(const int8_t* __restrict__ q_codes,
                           const float* __restrict__ q_scale,
                           const int8_t* __restrict__ k_pool,
                           const int8_t* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ tables,
                           const int* __restrict__ meta,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ scratch, int NB, int bs,
                           int KV, int g, int hd, int MB, int qmax) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x - b * KV;
  const int S = MB * bs;
  const int hw = hd / 4;                      // code words per head row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int* q_s = reinterpret_cast<int*>(smem);    // [g, hw] q code words
  int* o_s = q_s + g * hw;                    // [kWarps, g, hd] AV sums
  float* red = reinterpret_cast<float*>(o_s + kWarps * g * hd);
  float* sq_s = red + kWarps * kMaxG;         // [kMaxG] q scales
  float* m_s = sq_s + kMaxG;                  // [kMaxG] row max
  float* den_s = m_s + kMaxG;                 // [kMaxG] row sum
  float* spv_s = den_s + kMaxG;               // [kMaxG] max |pv|, then scale
  float* s_s = scratch != nullptr
      ? scratch + static_cast<size_t>(blockIdx.x) * g * S
      : spv_s + kMaxG;                        // [g, S] scores, p, pv, codes

  const int qpos = meta[b * 3 + 2];
  const int kvv = meta[b * 3 + 1];
  const int* tbl = tables + static_cast<size_t>(b) * MB;
  const size_t head = static_cast<size_t>(b) * KV + h;
  const int* qw = reinterpret_cast<const int*>(q_codes + head * g * hd);
  for (int i = tid; i < g * hw; i += kThreads) q_s[i] = qw[i];
  if (tid < g) sq_s[tid] = q_scale[head * g + tid];
  __syncthreads();

  // 1) scores: a thread per position, g __dp4a sums in registers; masked
  //    positions are -1e30 whatever their dot, so they skip it
  for (int p = tid; p < S; p += kThreads) {
    int dot[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) dot[gi] = 0;
    const bool valid = p <= qpos && p < kvv;
    const int blk = tbl[p / bs];
    float ks = 0.f;
    if (valid && blk < NB) {
      const size_t pos = (static_cast<size_t>(blk) * bs + p % bs) * KV + h;
      ks = k_scale[pos];
      const int4* row = reinterpret_cast<const int4*>(k_pool + pos * hd);
      for (int w4 = 0; w4 < hw / 4; ++w4) {
        const int4 kv = row[w4];
        const int words[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi) {
            if (gi < g) {
              dot[gi] = __dp4a(words[i], q_s[gi * hw + 4 * w4 + i], dot[gi]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        s_s[gi * S + p] = valid
            ? __fmul_rn(__fmul_rn(static_cast<float>(dot[gi]), sq_s[gi]), ks)
            : kMasked;
      }
    }
  }
  __syncthreads();

  // 2) full-row max per head
  float v[kMaxG];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) v[gi] = kMasked;
  for (int p = tid; p < S; p += kThreads) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) v[gi] = fmaxf(v[gi], s_s[gi * S + p]);
    }
  }
  block_reduce<true>(v, g, red, m_s);

  // 3) e = exp(s - max) in place, and the row sum
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) v[gi] = 0.f;
  for (int p = tid; p < S; p += kThreads) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        const float e = expf(__fsub_rn(s_s[gi * S + p], m_s[gi]));
        s_s[gi * S + p] = e;
        v[gi] = __fadd_rn(v[gi], e);
      }
    }
  }
  block_reduce<false>(v, g, red, den_s);

  // 4) pv = (e / sum) * vs in place, and max |pv| per head (pv >= 0)
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) v[gi] = 0.f;
  for (int p = tid; p < S; p += kThreads) {
    const int blk = tbl[p / bs];
    const float vs = blk < NB
        ? v_scale[(static_cast<size_t>(blk) * bs + p % bs) * KV + h]
        : 0.f;
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        const float pv =
            __fmul_rn(__fdiv_rn(s_s[gi * S + p], den_s[gi]), vs);
        s_s[gi * S + p] = pv;
        v[gi] = fmaxf(v[gi], pv);
      }
    }
  }
  block_reduce<true>(v, g, red, spv_s);
  if (tid < g) {
    spv_s[tid] = __fdiv_rn(fmaxf(spv_s[tid], 1e-12f),
                           static_cast<float>(qmax));
  }
  __syncthreads();

  // 5) requantize pv per head: codes rint(pv / scale), clipped
  const float qmin = static_cast<float>(-qmax - 1);
  for (int p = tid; p < S; p += kThreads) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        const float c = rintf(__fdiv_rn(s_s[gi * S + p], spv_s[gi]));
        s_s[gi * S + p] = fminf(fmaxf(c, qmin), static_cast<float>(qmax));
      }
    }
  }
  __syncthreads();

  // 6) AV: a warp per position, lanes over 4-dim groups, exact int32 sums;
  //    positions whose g codes are all zero, and sentinel blocks, add
  //    nothing and are skipped
  for (int d0 = 4 * lane; d0 < hd; d0 += 128) {
    int acc[kMaxG][4];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[gi][i] = 0;
    }
    for (int p = warp; p < S; p += kWarps) {
      const int blk = tbl[p / bs];
      if (blk >= NB) continue;
      int code[kMaxG];
      bool any = false;
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        code[gi] = gi < g ? static_cast<int>(s_s[gi * S + p]) : 0;
        any |= code[gi] != 0;
      }
      if (!any) continue;
      const size_t pos = (static_cast<size_t>(blk) * bs + p % bs) * KV + h;
      const char4 w = *reinterpret_cast<const char4*>(v_pool + pos * hd + d0);
      const int val[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < g) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[gi][i] += code[gi] * val[i];
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o_s[(warp * g + gi) * hd + d0 + i] = acc[gi][i];
        }
      }
    }
  }
  __syncthreads();
  const size_t out_base = head * g * hd;
  for (int i = tid; i < g * hd; i += kThreads) {
    int acc = o_s[i];
    for (int w = 1; w < kWarps; ++w) acc += o_s[w * g * hd + i];
    out[out_base + i] = __float2bfloat16_rn(
        __fmul_rn(static_cast<float>(acc), spv_s[i / hd]));
  }
}

size_t int_smem_bytes(int g, int hd, int S, bool with_scores) {
  return (static_cast<size_t>(g) * hd / 4 + static_cast<size_t>(kWarps) * g * hd
          + kWarps * kMaxG + 4 * kMaxG
          + (with_scores ? static_cast<size_t>(g) * S : 0)) * 4;
}

}  // namespace

// Shared-memory bytes the kernel needs with its score row on chip: the
// wrapper passes a global scratch row instead when this is too large.
extern "C" long long paged_attention_smem_bytes(int g, int hd, int S) {
  return static_cast<long long>(smem_bytes(g, hd, S, true));
}

// quant = 1: int8 pools + f32 per-position scales; 0: bf16 pools.
// hd must be a multiple of 16 and every pool row 16-byte aligned.
extern "C" int paged_attention_float(const void* q, const void* k_pool,
                                     const void* v_pool, const float* k_scale,
                                     const float* v_scale, const int* tables,
                                     const int* meta, void* out,
                                     float* scratch, int quant, int B, int NB,
                                     int bs, int KV, int g, int hd, int MB,
                                     float sm_scale, int cordic, int lv_n,
                                     const CordicParams* cp, void* stream) {
  if (B <= 0 || KV <= 0 || g <= 0 || g > kMaxG || hd <= 0 || hd % 16 != 0 ||
      bs <= 0 || MB <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = quant
      ? launch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables, meta, out,
                       scratch, B, NB, bs, KV, g, hd, MB, sm_scale, cordic,
                       lv_n, *cp, s)
      : launch<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale, tables,
                              meta, out, scratch, B, NB, bs, KV, g, hd, MB,
                              sm_scale, cordic, lv_n, *cp, s);
  return static_cast<int>(err);
}

// The integer body's shared-memory bytes with its score row on chip.
extern "C" long long paged_attention_int_smem_bytes(int g, int hd, int S) {
  return static_cast<long long>(int_smem_bytes(g, hd, S, true));
}

// q_codes [B, KV, g, hd] int8 and q_scale [B, KV, g] f32; int8 pools with
// f32 per-position scales; out [B, KV * g, hd] bf16. hd must be a multiple
// of 16 and every pool and q row 16-byte aligned.
extern "C" int paged_attention_int(const int8_t* q_codes,
                                   const float* q_scale,
                                   const int8_t* k_pool, const int8_t* v_pool,
                                   const float* k_scale, const float* v_scale,
                                   const int* tables, const int* meta,
                                   void* out, float* scratch, int B, int NB,
                                   int bs, int KV, int g, int hd, int MB,
                                   int qmax, void* stream) {
  if (B <= 0 || KV <= 0 || g <= 0 || g > kMaxG || hd <= 0 || hd % 16 != 0 ||
      bs <= 0 || MB <= 0 || qmax <= 0 || qmax > 127) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = int_smem_bytes(g, hd, MB * bs, scratch == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_int_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attention_int_kernel<<<B * KV, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      q_codes, q_scale, k_pool, v_pool, k_scale, v_scale, tables, meta,
      static_cast<__nv_bfloat16*>(out), scratch, NB, bs, KV, g, hd, MB, qmax);
  return static_cast<int>(cudaGetLastError());
}
