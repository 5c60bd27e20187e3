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
// What bounds it: each position of a row's valid window is read once (its
// K and V rows and scales); the arithmetic is ~4 f32 operations per byte
// at g 5, far below the card's ~20 per byte of memory bandwidth, so the
// least time is the bytes over 3.35 TB/s. What kept the kernel this one
// replaced at 1-2% of that was parallelism: a block per (row, KV head)
// put 32 blocks on 132 SMs at decode's 4 rows x 8 KV heads, each walking
// its whole table width with one dependent load per thread in flight.
// What bounds this design (tools/attention_timeline.py, H100): a CTA's
// instructions per tile (the per-element dequant, the g dot products,
// the barriers) and, at short rows, the fixed cost of the phases between
// the tiles (the table and q loads, three to five cluster barriers, the
// merges): 10-13 µs at the serve paths' 96-position tables.
//
// The design:
//  * One launch of a thread-block cluster of C CTAs per (row b, KV head
//    h), C in {1, 2, 4, 8}, chosen on the host from shapes only
//    (kernels/paged_attention/paged_attention.py, cluster_size): the
//    largest C that leaves every CTA two pool blocks of a full table and
//    keeps the B * KV * C CTAs within what the card holds at once (three
//    256-thread CTAs an SM, the launch bound), so that the grid is one
//    wave.
//  * The row's valid window [0, W), W = min(qpos + 1, kvv), is read from
//    `meta` on the device. CTA r of C walks whole pool blocks
//    [r n / C, (r + 1) n / C) of the row's n = ceil(W / bs) blocks: the
//    slices are contiguous, cover the window once, and rows of different
//    lengths in one batch each use all C CTAs. A CTA whose slice is empty
//    contributes the identity (max -1e30, sum 0, AV 0).
//  * K and V rows stream through a four-stage ring of 64-position tiles
//    in shared memory, filled by 16-byte cp.async copies (the scales by
//    4-byte ones) that zero-fill sentinel entries; four lanes copy a
//    position's row, one table lookup each. The slice's K tiles come
//    first, then its V tiles, as one stream, so the first V tiles are in
//    flight while the cluster merges its maxima. Chunks of odd positions
//    are XOR-swizzled so that the two positions a quarter-warp reads land
//    in distinct banks. (Deeper rings, six or eight stages, and
//    128-position tiles measured no faster: the tiles' instructions, not
//    the bytes in flight, set the pace.)
//  * int8 codes are dequantized with integer and add operations (a code
//    as the low mantissa bits of 2^23, the bf16 round-to-nearest-even as
//    three integer operations), not the conversion unit: the same values
//    as __float2bfloat16_rn(code * scale).
//  * Scores: the same four lanes a position, each a quarter of the head's
//    16-byte chunks, g sums in registers, summed over the four lanes by
//    a fixed butterfly; q sits in shared memory (float4 reads), its chunks
//    padded apart. The slice's [g, positions] score row stays in shared
//    memory, or in a global scratch region per CTA where it does not fit
//    (tables wider than ~75k positions at C 8, g 5; ~50k for the integer
//    body, whose region also holds V scales and codes).
//  * Full-row semantics across the cluster, not a flash-style rescale:
//    each CTA takes its slice's local max per head; cluster.sync; every
//    CTA reads the C local maxima through distributed shared memory
//    (cooperative_groups::this_cluster().map_shared_rank) and forms the
//    row max M; e = exp(s - M), its local sum and the local AV partial
//    [g, hd] (lanes over head dims, position groups over positions, the
//    groups summed in a fixed order); cluster.sync; each CTA sums the C
//    partial sums in rank order 0..C-1, and its own share of the g x hd
//    AV elements in rank order (so the merge is split across the CTAs);
//    under CORDIC one more cluster.sync merges max |o| per head; then the
//    divide (exact, or lv_div on operands scaled by max(amax, den) +
//    1e-9) and the bf16 store; a last cluster.sync keeps every CTA's
//    shared memory alive until the others have read it.
//  * Arithmetic: f32 on the CUDA cores (p stays f32; a bf16 p for the
//    tensor cores would change the function). The q . k and AV dots use
//    __fmaf_rn: an explicit fused multiply-add is an intrinsic, not a
//    contraction, so the build's -fmad=false still holds for the CORDIC
//    range reduction; it rounds once where a multiply and an add round
//    twice, and halves the instructions of the loops that bound a CTA's
//    compute. The plain version's einsums round in their own order
//    either way (held within 1% of the output range).
//  * Positions at or past W are not visited. Under the exact exp they
//    add exactly 0 to the sum and nothing to AV. Under CORDIC, hr_exp
//    clamps z at -87, so the kernel this one replaced added e^-87 ~
//    1.6e-38 per such position to the sum: far below an f32 ulp of a sum
//    that holds e^0 = 1. Skipping them is the one change of function.
//  * A sentinel entry inside the window (as clear_table_entry can leave)
//    is zero-filled: its score is exactly 0, not masked; it adds
//    e(0 - M) to the sum and nothing to AV, as the plain version's
//    zero-filled gather does.
//  * An empty window (W = 0, an idle slot): every score of the table
//    width MB * bs is masked, so M = -1e30, z = 0 and every position
//    weighs e(0). The CTAs then split the whole table (no dot is taken),
//    and the output is the mean of V over the table width, sentinels as
//    zeros: the plain version's result, never 0 / 0.
//  * Deterministic: slice boundaries, rank order and every reduction
//    order follow from shapes and `meta` alone; no atomics. Nothing is
//    read back to the host and nothing is allocated beyond the output
//    (and the scratch, at widths that need it), so the launch can be
//    captured in a CUDA graph.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cordic.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinCtas = 3;         // CTAs an SM holds (launch bounds)
constexpr int kMaxG = 8;            // query heads per KV head
constexpr int kMaxHd = 256;         // head dims
constexpr int kMaxCluster = 8;      // CTAs per (row, KV head)
constexpr int kStagePos = 64;       // positions per ring tile
constexpr int kStages = 4;          // ring depth
constexpr int kPosLanes = kThreads / kStagePos;   // lanes a position
constexpr float kMasked = -1e30f;
// red [kWarps, kMaxG], then eight per-head arrays of kMaxG
constexpr int kStatFloats = kWarps * kMaxG + 8 * kMaxG;

// the bodies: the float one on int8 or bf16 pools, the integer one
enum Body { kBodyInt = 0, kBodyInt8Pool = 1, kBodyBf16Pool = 2 };

// Phase probes for tools/attention_timeline.py: a build with
// -DPA_TIMELINE has thread 0 of every CTA record %globaltimer (ns) at each
// phase boundary; the shipped build compiles them away.
#ifdef PA_TIMELINE
__device__ unsigned long long pa_probes[1 << 16];
#define PA_PROBE(k)                                                      \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      unsigned long long t_;                                             \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));             \
      pa_probes[blockIdx.x * 16 + (k)] = t_;                             \
    }                                                                    \
  } while (0)
#else
#define PA_PROBE(k) \
  do {              \
  } while (0)
#endif

// Byte k of u (an int8 code plus 128, as u = word ^ 0x80808080 gives it)
// as a float, exactly: the byte as the low mantissa bits of 2^23, less
// 2^23 + 128 — integer and add operations, no conversion instruction.
__device__ __forceinline__ float code_f32(unsigned u, int k) {
  return __fadd_rn(__int_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | k)),
                   -8388736.f);
}

// x rounded to the nearest bf16, ties to even, back in f32: what
// __float2bfloat16_rn then __bfloat162float give for every finite x, in
// three integer operations.
__device__ __forceinline__ float snap_bf16(float x) {
  unsigned u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// code k of a word of int8 codes (given as word ^ 0x80808080) times its
// scale, snapped to bf16: the reference's dequantize
__device__ __forceinline__ float dequant(unsigned u, int k, float scale) {
  return snap_bf16(__fmul_rn(code_f32(u, k), scale));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Slot of 16-byte chunk c of position j's row in a tile: rows of R chunks
// one after the other, odd positions' chunks XORed with 4 when R is a
// multiple of 8 (the two positions of a quarter-warp then hit distinct
// banks; narrower rows already do).
__device__ __forceinline__ int chunk_slot(int c, int j, int R) {
  return (R & 7) == 0 ? c ^ ((j & 1) << 2) : c;
}

// 16 bytes of a K row in shared memory -> float values (16 int8 codes or
// 8 bf16 values); kQStride: floats between q's chunks in shared memory
// (padded for int8 so that the four lanes of a position read q in
// distinct banks)
template <typename PoolT>
struct Vec16;

template <>
struct Vec16<int8_t> {
  static constexpr int kN = 16;
  static constexpr int kQStride = 20;
  __device__ static void load(const char* p, float scale, float* out) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned u = words[i] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k) out[4 * i + k] = dequant(u, k, scale);
    }
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  static constexpr int kQStride = 8;
  __device__ static void load(const char* p, float, float* out) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(words[i] << 16);
      out[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
    }
  }
};

// head dims 4 dg .. 4 dg + 3 of position j's row in a tile -> floats
__device__ __forceinline__ void load4(const char* row, int dg, int j, int R,
                                      float scale, const int8_t*,
                                      float* out) {
  const unsigned u = *reinterpret_cast<const unsigned*>(
      row + (chunk_slot(dg >> 2, j, R) << 4) + ((dg & 3) << 2)) ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = dequant(u, k, scale);
}

__device__ __forceinline__ void load4(const char* row, int dg, int j, int R,
                                      float, const __nv_bfloat16*,
                                      float* out) {
  const uint2 w = *reinterpret_cast<const uint2*>(
      row + (chunk_slot(dg >> 1, j, R) << 4) + ((dg & 1) << 3));
  out[0] = __uint_as_float(w.x << 16);
  out[1] = __uint_as_float(w.x & 0xFFFF0000u);
  out[2] = __uint_as_float(w.y << 16);
  out[3] = __uint_as_float(w.y & 0xFFFF0000u);
}

// 4 x 4 byte transpose: word k of r holds 4 bytes of row k; word i of t
// holds byte i of rows 0..3
__device__ __forceinline__ void transpose4(const unsigned (&r)[4],
                                           unsigned (&t)[4]) {
  const unsigned x = __byte_perm(r[0], r[1], 0x5140);
  const unsigned y = __byte_perm(r[2], r[3], 0x5140);
  const unsigned z = __byte_perm(r[0], r[1], 0x7362);
  const unsigned w = __byte_perm(r[2], r[3], 0x7362);
  t[0] = __byte_perm(x, y, 0x5410);
  t[1] = __byte_perm(x, y, 0x7632);
  t[2] = __byte_perm(z, w, 0x5410);
  t[3] = __byte_perm(z, w, 0x7632);
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

// local[idx] of the cluster's C CTAs through distributed shared memory,
// all loads issued before any is used
template <typename T>
__device__ __forceinline__ void cluster_gather(cg::cluster_group& cluster,
                                               T* local, int idx, int C,
                                               T (&x)[kMaxCluster]) {
#pragma unroll
  for (int rr = 0; rr < kMaxCluster; ++rr) {
    x[rr] = rr < C ? cluster.map_shared_rank(local, rr)[idx] : T(0);
  }
}

// ... folded in rank order 0..C-1: a sum (IEEE adds, from 0) or a max
// (exact in any order, from `init`)
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* local, int idx, int C) {
  float x[kMaxCluster];
  cluster_gather(cluster, local, idx, C, x);
  float a = 0.f;
#pragma unroll
  for (int rr = 0; rr < kMaxCluster; ++rr) {
    if (rr < C) a = __fadd_rn(a, x[rr]);
  }
  return a;
}

__device__ __forceinline__ int cluster_sum(cg::cluster_group& cluster,
                                           int* local, int idx, int C) {
  int x[kMaxCluster];
  cluster_gather(cluster, local, idx, C, x);
  int a = 0;
#pragma unroll
  for (int rr = 0; rr < kMaxCluster; ++rr) a += x[rr];
  return a;
}

__device__ __forceinline__ float cluster_max(cg::cluster_group& cluster,
                                             float* local, int idx, int C,
                                             float init) {
  float x[kMaxCluster];
  cluster_gather(cluster, local, idx, C, x);
  float a = init;
#pragma unroll
  for (int rr = 0; rr < kMaxCluster; ++rr) {
    if (rr < C) a = fmaxf(a, x[rr]);
  }
  return a;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// A tile: kStagePos rows of row_bytes, then two scale arrays of kStagePos
// floats (K tiles of the float body and V tiles: the tile's own scales;
// K tiles of the integer body: the K and the V scales).
__host__ __device__ inline size_t stage_bytes(int row_bytes) {
  return static_cast<size_t>(kStagePos) * (row_bytes + 8);
}

__host__ __device__ inline int pool_row_bytes(int body, int hd) {
  return body == kBodyBf16Pool ? 2 * hd : hd;
}

// Bytes of a CTA's score region for slices of `cap` positions: the float
// body's [g, cap] f32 scores; the integer body's [g, cap] f32 scores, the
// slice's [cap] f32 V scales and its [g, cap rounded up to 4] int8 p.v
// codes. In shared memory, or in the global scratch, one region a CTA.
__host__ __device__ inline size_t score_bytes(int body, int g, int cap) {
  const size_t f32 = static_cast<size_t>(g) * cap * 4;
  if (body != kBodyInt) return align16(f32);
  return align16(f32 + static_cast<size_t>(cap) * 4
                 + static_cast<size_t>(g) * ((cap + 3) & ~3));
}

// Byte offsets of a CTA's shared memory. The ring also holds the AV
// partials of the position groups ([kThreads / (hd / 4), g, hd] words,
// at most g * 4096 bytes) once its last tile is read, and then the CTA's
// merged share of the output.
struct Smem {
  size_t q, tbl, ring, o, stats, scores, total;
};

__host__ __device__ inline Smem smem_layout(int body, int g, int hd,
                                            int cap_blocks, int bs,
                                            bool with_scores) {
  const int row_bytes = pool_row_bytes(body, hd);
  const int R = row_bytes / 16;
  const size_t q_bytes =
      body == kBodyInt ? static_cast<size_t>(g) * hd
      : static_cast<size_t>(g) * R
            * (body == kBodyInt8Pool ? Vec16<int8_t>::kQStride
                                     : Vec16<__nv_bfloat16>::kQStride) * 4;
  Smem s;
  size_t off = 0;
  s.q = off;
  off = align16(off + q_bytes);
  s.tbl = off;
  off = align16(off + static_cast<size_t>(cap_blocks) * 4);
  s.ring = off;
  const size_t ring = kStages * stage_bytes(row_bytes);
  const size_t partial = static_cast<size_t>(g) * 4096;
  off = align16(off + (ring > partial ? ring : partial));
  s.o = off;
  off = align16(off + static_cast<size_t>(g) * hd * 4);
  s.stats = off;
  off = align16(off + kStatFloats * 4);
  s.scores = off;
  if (with_scores) off += score_bytes(body, g, cap_blocks * bs);
  s.total = off;
  return s;
}

// A CTA's slice of its row: positions [lo, hi), whose table slots start
// at blk0; w is the valid window [0, w) (0: an empty window, whose CTAs
// split the whole table width with every score masked).
struct Slice {
  int lo, hi, w, blk0;
};

__device__ __forceinline__ Slice row_slice(const int* meta, int b, int MB,
                                           int bs, int C, int r) {
  const int S = MB * bs;
  const int qpos = meta[b * 3 + 2];
  const int kvv = meta[b * 3 + 1];
  int w = qpos < kvv - 1 ? qpos + 1 : kvv;
  w = w < 0 ? 0 : (w > S ? S : w);
  const int walk = w > 0 ? w : S;
  const int n = (walk + bs - 1) / bs;
  const int b0 = r * n / C;
  const int b1 = (r + 1) * n / C;
  Slice s;
  s.blk0 = b0;
  s.lo = b0 * bs;
  s.hi = b1 * bs < walk ? b1 * bs : walk;
  if (s.hi < s.lo) s.hi = s.lo;
  s.w = w;
  return s;
}

// Everything a CTA needs to fill its ring.
struct Stream {
  const char* k_pool;
  const char* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tbl_s;         // the slice's table entries, in shared memory
  char* ring;
  int NB, bs, KV, h, row_bytes, R, nst;
};

// Issue tile t of the slice's stream: K tiles 0..nst-1, then V tiles
// nst..2 nst-1, each 64 positions. The kPosLanes lanes of position j copy
// its row's 16-byte chunks (one table lookup each); kKScales: K tiles
// carry their scales (and, kKVScales, the V scales of the same
// positions); kVScales: V tiles carry theirs. Sentinel entries are
// zero-filled; positions past the slice are not copied.
template <bool kKScales, bool kKVScales, bool kVScales>
__device__ __forceinline__ void issue_tile(const Stream& st, const Slice& s,
                                           int t) {
  if (t >= 2 * st.nst) return;
  const bool is_v = t >= st.nst;
  const int j = threadIdx.x / kPosLanes;
  const int sub = threadIdx.x % kPosLanes;
  const int rel = (is_v ? t - st.nst : t) * kStagePos + j;
  if (s.lo + rel >= s.hi) return;
  const int blk = st.tbl_s[rel / st.bs];
  const bool ok = blk < st.NB;
  const size_t row = ok
      ? (static_cast<size_t>(blk) * st.bs + rel % st.bs) * st.KV + st.h : 0;
  char* tile = st.ring + (t % kStages) * stage_bytes(st.row_bytes);
  const char* src = (is_v ? st.v_pool : st.k_pool) + row * st.row_bytes;
  for (int c = sub; c < st.R; c += kPosLanes) {
    cp_async16(tile + j * st.row_bytes + (chunk_slot(c, j, st.R) << 4),
               src + c * 16, ok);
  }
  float* scales = reinterpret_cast<float*>(tile + kStagePos * st.row_bytes);
  if (sub == 0 && (is_v ? kVScales : kKScales)) {
    cp_async4(scales + j, (is_v ? st.v_scale : st.k_scale) + row, ok);
  }
  if (sub == 1 && !is_v && kKVScales) {
    cp_async4(scales + kStagePos + j, st.v_scale + row, ok);
  }
}

// Wait for tile t, let every thread pass the tile before it, and issue
// the tile that reuses that one's stage.
template <bool kKScales, bool kKVScales, bool kVScales>
__device__ __forceinline__ const char* next_tile(const Stream& st,
                                                 const Slice& s, int t) {
  cp_async_wait<kStages - 2>();
  __syncthreads();
  issue_tile<kKScales, kKVScales, kVScales>(st, s, t + kStages - 1);
  cp_async_commit();
  return st.ring + (t % kStages) * stage_bytes(st.row_bytes);
}

// the AV lanes: lanes over 4-dim groups, groups over positions
struct AvLanes {
  int nd, npg, pg, dg;
  __device__ explicit AvLanes(int hd)
      : nd(hd / 4), npg(kThreads / (hd / 4)),
        pg(static_cast<int>(threadIdx.x) / (hd / 4)),
        dg(static_cast<int>(threadIdx.x) % (hd / 4)) {}
};

template <typename PoolT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const PoolT* __restrict__ k_pool,
                       const PoolT* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ meta,
                       __nv_bfloat16* __restrict__ out,
                       char* __restrict__ scratch, int NB, int bs, int KV,
                       int g, int hd, int MB, int cap, float sm_scale,
                       int cordic, int lv_n, CordicParams cp) {
  constexpr bool kQuant = sizeof(PoolT) == 1;
  constexpr int kBody = kQuant ? kBodyInt8Pool : kBodyBf16Pool;
  using V = Vec16<PoolT>;
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int pair = blockIdx.x / C;
  const int b = pair / KV;
  const int h = pair - b * KV;
  const int tid = threadIdx.x;
  const int row_bytes = pool_row_bytes(kBody, hd);
  const int R = row_bytes / 16;

  const Smem L = smem_layout(kBody, g, hd, cap / bs, bs, scratch == nullptr);
  float* q_s = reinterpret_cast<float*>(smem + L.q);   // [g, R, kQStride]
  int* tbl_s = reinterpret_cast<int*>(smem + L.tbl);
  float* o_loc = reinterpret_cast<float*>(smem + L.o);       // [g, hd]
  float* red = reinterpret_cast<float*>(smem + L.stats);
  float* m_loc = red + kWarps * kMaxG;   // this CTA's max, sum, max |o|
  float* den_loc = m_loc + kMaxG;
  float* amax_loc = den_loc + kMaxG;
  float* m_row = amax_loc + kMaxG;       // the row's
  float* den_row = m_row + kMaxG;
  float* amax_row = den_row + kMaxG;
  float* s_s = reinterpret_cast<float*>(
      scratch != nullptr
          ? scratch + blockIdx.x * score_bytes(kBody, g, cap)
          : smem + L.scores);                         // [g, cap]

  PA_PROBE(0);
  const Slice s = row_slice(meta, b, MB, bs, C, r);
  const int len = s.hi - s.lo;
  const int* tbl = tables + static_cast<size_t>(b) * MB + s.blk0;
  for (int i = tid; i < (len + bs - 1) / bs; i += kThreads) {
    tbl_s[i] = tbl[i];
  }
  const size_t head = static_cast<size_t>(b) * KV + h;
  for (int i = tid; i < g * hd; i += kThreads) {
    const int gi = i / hd;
    const int d = i - gi * hd;
    q_s[(gi * R + d / V::kN) * V::kQStride + d % V::kN] =
        __bfloat162float(q[head * g * hd + i]);
  }
  __syncthreads();
  PA_PROBE(1);

  Stream st;
  st.k_pool = reinterpret_cast<const char*>(k_pool);
  st.v_pool = reinterpret_cast<const char*>(v_pool);
  st.k_scale = k_scale;
  st.v_scale = v_scale;
  st.tbl_s = tbl_s;
  st.ring = smem + L.ring;
  st.NB = NB;
  st.bs = bs;
  st.KV = KV;
  st.h = h;
  st.row_bytes = row_bytes;
  st.R = R;
  st.nst = (len + kStagePos - 1) / kStagePos;
  for (int t = 0; t < kStages - 1; ++t) {
    issue_tile<kQuant, false, kQuant>(st, s, t);
    cp_async_commit();
  }

  // 1) scores of the slice: four lanes a position, g sums in registers
  float mx[kMaxG];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) mx[gi] = kMasked;
  const int j = tid / kPosLanes;
  const int sub = tid % kPosLanes;
  for (int t = 0; t < st.nst; ++t) {
    const char* tile = next_tile<kQuant, false, kQuant>(st, s, t);
    const int p = s.lo + t * kStagePos + j;
    const bool in_tile = p < s.hi;
    const bool valid = in_tile && p < s.w;
    float part[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) part[gi] = 0.f;
    if (valid) {
      const float sc = kQuant ? reinterpret_cast<const float*>(
          tile + kStagePos * row_bytes)[j] : 0.f;
      const char* row = tile + j * row_bytes;
      for (int c = sub; c < R; c += kPosLanes) {
        float kv[V::kN];
        V::load(row + (chunk_slot(c, j, R) << 4), sc, kv);
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          if (gi < g) {
            const float4* qc = reinterpret_cast<const float4*>(
                q_s + (gi * R + c) * V::kQStride);
#pragma unroll
            for (int i4 = 0; i4 < V::kN / 4; ++i4) {
              const float4 qv = qc[i4];
              part[gi] = __fmaf_rn(qv.x, kv[4 * i4], part[gi]);
              part[gi] = __fmaf_rn(qv.y, kv[4 * i4 + 1], part[gi]);
              part[gi] = __fmaf_rn(qv.z, kv[4 * i4 + 2], part[gi]);
              part[gi] = __fmaf_rn(qv.w, kv[4 * i4 + 3], part[gi]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
#pragma unroll
        for (int o = 1; o < kPosLanes; o <<= 1) {
          part[gi] = __fadd_rn(part[gi],
                               __shfl_xor_sync(0xffffffffu, part[gi], o));
        }
        if (sub == 0 && in_tile) {
          const float sv = valid ? __fmul_rn(part[gi], sm_scale) : kMasked;
          s_s[gi * cap + p - s.lo] = sv;
          mx[gi] = fmaxf(mx[gi], sv);
        }
      }
    }
  }
  PA_PROBE(2);
  block_reduce<true>(mx, g, red, m_loc);

  // 2) the row max from the cluster's local maxima (exact in any order)
  cluster.sync();
  if (tid < g) m_row[tid] = cluster_max(cluster, m_loc, tid, C, kMasked);
  __syncthreads();
  PA_PROBE(3);

  // 3) e = exp(s - M) in place, and the slice's sum: a thread per
  //    (head, position), heads outer
  float v[kMaxG];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) v[gi] = 0.f;
  for (int idx = tid; idx < g * len; idx += kThreads) {
    const int gi = idx / len;
    const int i = idx - gi * len;
    const float z = __fsub_rn(s_s[gi * cap + i], m_row[gi]);
    const float e = cordic ? hr_exp(z, cp) : expf(z);
    s_s[gi * cap + i] = e;
#pragma unroll
    for (int gj = 0; gj < kMaxG; ++gj) {
      if (gj == gi) v[gj] = __fadd_rn(v[gj], e);
    }
  }
  block_reduce<false>(v, g, red, den_loc);
  PA_PROBE(4);

  // 4) the slice's AV partial over the V tiles
  const AvLanes av(hd);
  float acc[kMaxG][4];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[gi][i] = 0.f;
  }
  for (int t = st.nst; t < 2 * st.nst; ++t) {
    const char* tile = next_tile<kQuant, false, kQuant>(st, s, t);
    const int p0 = s.lo + (t - st.nst) * kStagePos;
    const int n = min(kStagePos, s.hi - p0);
    if (av.pg >= av.npg) continue;
    const float* scales =
        reinterpret_cast<const float*>(tile + kStagePos * row_bytes);
    for (int jj = av.pg; jj < n; jj += av.npg) {
      float val[4];
      load4(tile + jj * row_bytes, av.dg, jj, R, kQuant ? scales[jj] : 0.f,
            static_cast<const PoolT*>(nullptr), val);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < g) {
          const float e = s_s[gi * cap + p0 + jj - s.lo];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[gi][i] = __fmaf_rn(e, val[i], acc[gi][i]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  PA_PROBE(5);
  float* part = reinterpret_cast<float*>(st.ring);   // [npg, g, hd]
  if (av.pg < av.npg) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          part[(av.pg * g + gi) * hd + 4 * av.dg + i] = acc[gi][i];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < g * hd; i += kThreads) {
    float a = part[i];
    for (int pg = 1; pg < av.npg; ++pg) a = __fadd_rn(a, part[pg * g * hd + i]);
    o_loc[i] = a;
  }

  // 5) merge in rank order: every CTA the sums, each its share of AV
  PA_PROBE(6);
  cluster.sync();
  const int E = g * hd;
  const int e0 = r * E / C;
  const int e1 = (r + 1) * E / C;
  float* o_fin = reinterpret_cast<float*>(st.ring);  // [e1 - e0]
  for (int i = e0 + tid; i < e1; i += kThreads) {
    o_fin[i - e0] = cluster_sum(cluster, o_loc, i, C);
  }
  if (tid < g) den_row[tid] = cluster_sum(cluster, den_loc, tid, C);
  __syncthreads();
  PA_PROBE(7);

  // 6) the divide: exact, or LV CORDIC on operands scaled into [-1, 1]
  //    by the head's max |o| over the whole row (one more merge)
  if (cordic) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) v[gi] = 0.f;
    for (int i = e0 + tid; i < e1; i += kThreads) {
      const int gi = i / hd;
#pragma unroll
      for (int gj = 0; gj < kMaxG; ++gj) {
        if (gj == gi) v[gj] = fmaxf(v[gj], fabsf(o_fin[i - e0]));
      }
    }
    block_reduce<true>(v, g, red, amax_loc);
    cluster.sync();
    if (tid < g) amax_row[tid] = cluster_max(cluster, amax_loc, tid, C, 0.f);
    __syncthreads();
  }
  const size_t out_base = head * g * hd;
  for (int i = e0 + tid; i < e1; i += kThreads) {
    const int gi = i / hd;
    const float den = den_row[gi];
    const float o = o_fin[i - e0];
    float res;
    if (cordic) {
      const float sc = __fadd_rn(fmaxf(amax_row[gi], den), 1e-9f);
      res = lv_div(__fdiv_rn(o, sc), __fdiv_rn(den, sc), lv_n);
    } else {
      res = __fdiv_rn(o, den);
    }
    out[out_base + i] = __float2bfloat16_rn(res);
  }
  cluster.sync();
  PA_PROBE(8);
}

cudaLaunchConfig_t cluster_config(int B, int KV, int C, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * KV * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(C);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename PoolT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* meta, void* out,
                   char* scratch, int B, int NB, int bs, int KV, int g,
                   int hd, int MB, int C, int cap, float sm_scale,
                   int cordic, int lv_n, const CordicParams& cp,
                   cudaStream_t stream) {
  const int body = sizeof(PoolT) == 1 ? kBodyInt8Pool : kBodyBf16Pool;
  const size_t smem = smem_layout(body, g, hd, cap / bs, bs,
                                  scratch == nullptr).total;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<PoolT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(B, KV, C, smem, stream,
                                                &attr);
  err = cudaLaunchKernelEx(
      &cfg, paged_attention_kernel<PoolT>,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const PoolT*>(k_pool), static_cast<const PoolT*>(v_pool),
      k_scale, v_scale, tables, meta, static_cast<__nv_bfloat16*>(out),
      scratch, NB, bs, KV, g, hd, MB, cap, sm_scale, cordic, lv_n, cp);
  if (err != cudaSuccess) return err;
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
// position of the window (~2 operations per byte): memory, and at decode's
// batch how few blocks are in flight and how little each keeps in flight.
// The design is the float body's: a cluster of C CTAs per (row, KV head),
// each walking its slice of the window through the same cp.async ring
// (K tiles carry the K and the V scales of their positions), four lanes a
// position for the scores (g __dp4a sums in registers), the score row on
// chip (or in a global scratch region where it does not fit). The
// requantize needs two more cluster-wide steps before the AV, each merged
// through distributed shared memory behind a cluster.sync: the row sum,
// since pv = (e / den) * vs needs the whole row's den (in rank order),
// then the max |pv| per head for the requantize scale (a max, exact in
// any order). The p.v codes then sit as int8 words of four positions, and
// the AV takes __dp4a of each word with the V bytes of the same four
// positions (a lane's word of each of four rows, byte-transposed): exact
// int32 sums, merged exactly in any order, each CTA its share of the
// g x hd outputs. Positions past the window are not visited (their e is
// exactly 0, so their pv and codes are 0); an empty window weighs every
// position of the table width alike, as the float body does, and an
// all-sentinel row then reads zero v scales: an exact zero output.
__global__ void __launch_bounds__(kThreads, kMinCtas)
paged_attention_int_kernel(const int8_t* __restrict__ q_codes,
                           const float* __restrict__ q_scale,
                           const int8_t* __restrict__ k_pool,
                           const int8_t* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ tables,
                           const int* __restrict__ meta,
                           __nv_bfloat16* __restrict__ out,
                           char* __restrict__ scratch, int NB, int bs,
                           int KV, int g, int hd, int MB, int cap, int qmax) {
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int pair = blockIdx.x / C;
  const int b = pair / KV;
  const int h = pair - b * KV;
  const int tid = threadIdx.x;
  const int hw = hd / 4;                      // code words per head row
  const int R = hd / 16;
  const int cap4 = (cap + 3) & ~3;

  const Smem L = smem_layout(kBodyInt, g, hd, cap / bs, bs,
                             scratch == nullptr);
  int* q_s = reinterpret_cast<int*>(smem + L.q);      // [g, hw] code words
  int* tbl_s = reinterpret_cast<int*>(smem + L.tbl);
  int* o_loc = reinterpret_cast<int*>(smem + L.o);    // [g, hd]
  float* red = reinterpret_cast<float*>(smem + L.stats);
  float* m_loc = red + kWarps * kMaxG;     // this CTA's max, sum, max |pv|
  float* den_loc = m_loc + kMaxG;
  float* amax_loc = den_loc + kMaxG;
  float* m_row = amax_loc + kMaxG;         // the row's
  float* den_row = m_row + kMaxG;
  float* spv_row = den_row + kMaxG;        // requantize scale
  float* sq_s = spv_row + kMaxG;           // q scales
  char* region = scratch != nullptr
      ? scratch + blockIdx.x * score_bytes(kBodyInt, g, cap)
      : smem + L.scores;
  float* s_s = reinterpret_cast<float*>(region);        // [g, cap]
  float* vs_s = s_s + static_cast<size_t>(g) * cap;     // [cap] V scales
  int8_t* codes = reinterpret_cast<int8_t*>(vs_s + cap);  // [g, cap4]

  PA_PROBE(0);
  const Slice s = row_slice(meta, b, MB, bs, C, r);
  const int len = s.hi - s.lo;
  const int* tbl = tables + static_cast<size_t>(b) * MB + s.blk0;
  for (int i = tid; i < (len + bs - 1) / bs; i += kThreads) {
    tbl_s[i] = tbl[i];
  }
  const size_t head = static_cast<size_t>(b) * KV + h;
  const int* qw = reinterpret_cast<const int*>(q_codes + head * g * hd);
  for (int i = tid; i < g * hw; i += kThreads) q_s[i] = qw[i];
  if (tid < g) sq_s[tid] = q_scale[head * g + tid];
  __syncthreads();
  PA_PROBE(1);

  Stream st;
  st.k_pool = reinterpret_cast<const char*>(k_pool);
  st.v_pool = reinterpret_cast<const char*>(v_pool);
  st.k_scale = k_scale;
  st.v_scale = v_scale;
  st.tbl_s = tbl_s;
  st.ring = smem + L.ring;
  st.NB = NB;
  st.bs = bs;
  st.KV = KV;
  st.h = h;
  st.row_bytes = hd;
  st.R = R;
  st.nst = (len + kStagePos - 1) / kStagePos;
  // K tiles carry the K and the V scales of their positions (the
  // requantize reads the V scales before the AV); V tiles, codes only
  for (int t = 0; t < kStages - 1; ++t) {
    issue_tile<true, true, false>(st, s, t);
    cp_async_commit();
  }

  // 1) scores of the slice: four lanes a position, g __dp4a sums; the V
  //    scales kept beside them
  float mx[kMaxG];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) mx[gi] = kMasked;
  const int j = tid / kPosLanes;
  const int sub = tid % kPosLanes;
  for (int t = 0; t < st.nst; ++t) {
    const char* tile = next_tile<true, true, false>(st, s, t);
    const float* scales = reinterpret_cast<const float*>(tile + kStagePos * hd);
    const int p = s.lo + t * kStagePos + j;
    const bool in_tile = p < s.hi;
    const bool valid = in_tile && p < s.w;
    int dot[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) dot[gi] = 0;
    if (valid) {
      const char* row = tile + j * hd;
      for (int c = sub; c < R; c += kPosLanes) {
        const int4 kv = *reinterpret_cast<const int4*>(
            row + (chunk_slot(c, j, R) << 4));
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          if (gi < g) {
            const int4 qv = *reinterpret_cast<const int4*>(
                q_s + gi * hw + 4 * c);
            dot[gi] = __dp4a(kv.x, qv.x, dot[gi]);
            dot[gi] = __dp4a(kv.y, qv.y, dot[gi]);
            dot[gi] = __dp4a(kv.z, qv.z, dot[gi]);
            dot[gi] = __dp4a(kv.w, qv.w, dot[gi]);
          }
        }
      }
    }
    if (sub == 0 && in_tile) vs_s[p - s.lo] = scales[kStagePos + j];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
#pragma unroll
        for (int o = 1; o < kPosLanes; o <<= 1) {
          dot[gi] += __shfl_xor_sync(0xffffffffu, dot[gi], o);
        }
        if (sub == 0 && in_tile) {
          const float sv = valid
              ? __fmul_rn(__fmul_rn(static_cast<float>(dot[gi]), sq_s[gi]),
                          scales[j])
              : kMasked;
          s_s[gi * cap + p - s.lo] = sv;
          mx[gi] = fmaxf(mx[gi], sv);
        }
      }
    }
  }
  PA_PROBE(2);
  block_reduce<true>(mx, g, red, m_loc);

  // 2) the row max (exact in any order)
  cluster.sync();
  if (tid < g) m_row[tid] = cluster_max(cluster, m_loc, tid, C, kMasked);
  __syncthreads();
  PA_PROBE(3);

  // 3) e = exp(s - max) in place, the slice's sum, the row sum in rank
  //    order (every CTA the same); a thread per (head, position)
  float v[kMaxG];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) v[gi] = 0.f;
  for (int idx = tid; idx < g * len; idx += kThreads) {
    const int gi = idx / len;
    const int i = idx - gi * len;
    const float e = expf(__fsub_rn(s_s[gi * cap + i], m_row[gi]));
    s_s[gi * cap + i] = e;
#pragma unroll
    for (int gj = 0; gj < kMaxG; ++gj) {
      if (gj == gi) v[gj] = __fadd_rn(v[gj], e);
    }
  }
  block_reduce<false>(v, g, red, den_loc);
  cluster.sync();
  if (tid < g) den_row[tid] = cluster_sum(cluster, den_loc, tid, C);
  __syncthreads();
  PA_PROBE(4);

  // 4) pv = (e / sum) * vs in place, and max |pv| per head (pv >= 0),
  //    merged over the cluster into the requantize scale
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) v[gi] = 0.f;
  for (int idx = tid; idx < g * len; idx += kThreads) {
    const int gi = idx / len;
    const int i = idx - gi * len;
    const float pv =
        __fmul_rn(__fdiv_rn(s_s[gi * cap + i], den_row[gi]), vs_s[i]);
    s_s[gi * cap + i] = pv;
#pragma unroll
    for (int gj = 0; gj < kMaxG; ++gj) {
      if (gj == gi) v[gj] = fmaxf(v[gj], pv);
    }
  }
  block_reduce<true>(v, g, red, amax_loc);
  cluster.sync();
  if (tid < g) {
    spv_row[tid] = __fdiv_rn(
        fmaxf(cluster_max(cluster, amax_loc, tid, C, 0.f), 1e-12f),
        static_cast<float>(qmax));
  }
  __syncthreads();
  PA_PROBE(5);

  // 5) requantize pv per head: int8 codes rint(pv / scale), clipped;
  //    positions up to the next multiple of 4 hold code 0
  const float qmin = static_cast<float>(-qmax - 1);
  const int len4 = (len + 3) & ~3;
  for (int idx = tid; idx < g * len4; idx += kThreads) {
    const int gi = idx / len4;
    const int i = idx - gi * len4;
    float c = 0.f;
    if (i < len) {
      c = rintf(__fdiv_rn(s_s[gi * cap + i], spv_row[gi]));
      c = fminf(fmaxf(c, qmin), static_cast<float>(qmax));
    }
    codes[gi * cap4 + i] = static_cast<int8_t>(c);
  }
  PA_PROBE(6);

  // 6) the slice's AV partial over the V tiles, exact int32 sums: a word
  //    of four positions' codes per head against the byte-transposed V
  //    words of the same positions; quads whose codes are all zero add
  //    nothing and are skipped (the rows past the slice's end, stale, meet
  //    code 0)
  const AvLanes av(hd);
  const int* code_w = reinterpret_cast<const int*>(codes);
  int acc[kMaxG][4];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[gi][i] = 0;
  }
  for (int t = st.nst; t < 2 * st.nst; ++t) {
    const char* tile = next_tile<true, true, false>(st, s, t);
    const int q0 = (t - st.nst) * (kStagePos / 4);   // the tile's first quad
    const int nq = (min(kStagePos, len - (t - st.nst) * kStagePos) + 3) / 4;
    if (av.pg >= av.npg) continue;
    for (int jq = av.pg; jq < nq; jq += av.npg) {
      int cw[kMaxG];
      bool any = false;
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        cw[gi] = gi < g ? code_w[gi * (cap4 / 4) + q0 + jq] : 0;
        any |= cw[gi] != 0;
      }
      if (!any) continue;
      unsigned rw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int jj = 4 * jq + k;
        rw[k] = *reinterpret_cast<const unsigned*>(
            tile + jj * hd + (chunk_slot(av.dg >> 2, jj, R) << 4)
            + ((av.dg & 3) << 2));
      }
      unsigned tw[4];
      transpose4(rw, tw);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < g) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[gi][i] = __dp4a(static_cast<int>(tw[i]), cw[gi], acc[gi][i]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  PA_PROBE(7);
  int* part = reinterpret_cast<int*>(st.ring);        // [npg, g, hd]
  if (av.pg < av.npg) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          part[(av.pg * g + gi) * hd + 4 * av.dg + i] = acc[gi][i];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < g * hd; i += kThreads) {
    int a = part[i];
    for (int pg = 1; pg < av.npg; ++pg) a += part[pg * g * hd + i];
    o_loc[i] = a;
  }

  // 7) merge the exact int32 partials, each CTA its share of the outputs
  PA_PROBE(8);
  cluster.sync();
  const int E = g * hd;
  const size_t out_base = head * g * hd;
  for (int i = r * E / C + tid; i < (r + 1) * E / C; i += kThreads) {
    out[out_base + i] = __float2bfloat16_rn(__fmul_rn(
        static_cast<float>(cluster_sum(cluster, o_loc, i, C)),
        spv_row[i / hd]));
  }
  cluster.sync();
  PA_PROBE(9);
}

bool bad_plan(int C, int cap, int MB, int bs) {
  return !(C == 1 || C == 2 || C == 4 || C == kMaxCluster) ||
         cap % bs != 0 || cap / bs < (MB + C - 1) / C;
}

}  // namespace

// Shared-memory bytes a CTA of `body` (0 the integer body, 1 the float
// body on int8 pools, 2 on bf16 pools) asks for with slices of at most
// cap_blocks pool blocks, its score region on chip (with_scores) or not.
extern "C" long long paged_attention_smem_bytes(int body, int g, int hd,
                                                int bs, int cap_blocks,
                                                int with_scores) {
  return static_cast<long long>(
      smem_layout(body, g, hd, cap_blocks, bs, with_scores != 0).total);
}

// Bytes of a CTA's score region in the global scratch (the wrapper
// allocates B * KV * C of them when the region does not fit on chip).
extern "C" long long paged_attention_scratch_bytes(int body, int g, int bs,
                                                   int cap_blocks) {
  return static_cast<long long>(score_bytes(body, g, cap_blocks * bs));
}

// How many clusters of C CTAs, `smem` bytes each, the card holds at once
// (cudaOccupancyMaxActiveClusters; negative: the CUDA error).
extern "C" int paged_attention_max_clusters(int body, int C, int smem) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, 1, C, smem, nullptr,
                                                &attr);
  int n = 0;
  cudaError_t err;
  if (body == kBodyInt) {
    err = cudaFuncSetAttribute(paged_attention_int_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveClusters(&n, paged_attention_int_kernel,
                                           &cfg);
    }
  } else if (body == kBodyInt8Pool) {
    err = cudaFuncSetAttribute(paged_attention_kernel<int8_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveClusters(
          &n, paged_attention_kernel<int8_t>, &cfg);
    }
  } else {
    err = cudaFuncSetAttribute(paged_attention_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveClusters(
          &n, paged_attention_kernel<__nv_bfloat16>, &cfg);
    }
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// quant = 1: int8 pools + f32 per-position scales; 0: bf16 pools. C: CTAs
// per (row, KV head), 1, 2, 4 or 8; cap: positions a CTA's slice holds,
// ceil(MB / C) * bs; scratch: B * KV * C score regions, or null when they
// fit on chip. hd must be a multiple of 16 (at most 256) and every pool
// row 16-byte aligned.
extern "C" int paged_attention_float(const void* q, const void* k_pool,
                                     const void* v_pool, const float* k_scale,
                                     const float* v_scale, const int* tables,
                                     const int* meta, void* out,
                                     void* scratch, int quant, int B, int NB,
                                     int bs, int KV, int g, int hd, int MB,
                                     int C, int cap, float sm_scale,
                                     int cordic, int lv_n,
                                     const CordicParams* cp, void* stream) {
  if (B <= 0 || KV <= 0 || g <= 0 || g > kMaxG || hd <= 0 || hd % 16 != 0 ||
      hd > kMaxHd || bs <= 0 || MB <= 0 || bad_plan(C, cap, MB, bs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* scr = static_cast<char*>(scratch);
  cudaError_t err = quant
      ? launch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables, meta, out,
                       scr, B, NB, bs, KV, g, hd, MB, C, cap, sm_scale,
                       cordic, lv_n, *cp, s)
      : launch<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale, tables,
                              meta, out, scr, B, NB, bs, KV, g, hd, MB, C,
                              cap, sm_scale, cordic, lv_n, *cp, s);
  return static_cast<int>(err);
}

// q_codes [B, KV, g, hd] int8 and q_scale [B, KV, g] f32; int8 pools with
// f32 per-position scales; out [B, KV * g, hd] bf16. C, cap and scratch as
// above. hd must be a multiple of 16 (at most 256) and every pool and q
// row 16-byte aligned.
extern "C" int paged_attention_int(const int8_t* q_codes,
                                   const float* q_scale,
                                   const int8_t* k_pool, const int8_t* v_pool,
                                   const float* k_scale, const float* v_scale,
                                   const int* tables, const int* meta,
                                   void* out, void* scratch, int B, int NB,
                                   int bs, int KV, int g, int hd, int MB,
                                   int C, int cap, int qmax, void* stream) {
  if (B <= 0 || KV <= 0 || g <= 0 || g > kMaxG || hd <= 0 || hd % 16 != 0 ||
      hd > kMaxHd || bs <= 0 || MB <= 0 || qmax <= 0 || qmax > 127 ||
      bad_plan(C, cap, MB, bs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_layout(kBodyInt, g, hd, cap / bs, bs,
                                  scratch == nullptr).total;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_int_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      B, KV, C, smem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, paged_attention_int_kernel, q_codes, q_scale,
                           k_pool, v_pool, k_scale, v_scale, tables, meta,
                           static_cast<__nv_bfloat16*>(out),
                           static_cast<char*>(scratch), NB, bs, KV, g, hd, MB,
                           cap, qmax);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef PA_TIMELINE
// The probes of the last launch, 16 words a CTA.
extern "C" int paged_attention_probes(void* dst, size_t bytes) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, pa_probes, bytes));
}
#endif
