// fxp_gemm_fused — the Flex-PE MAC array with its fused dequant + AF
// epilogue, written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fxp_gemm/fxp_gemm.py, fxp_gemm_fused_pallas
// (body _gemm_kernel_fused, with _unpack_nibbles for packed weights),
// fxp_gemm_pallas and fxp4_gemm_packed_pallas. Computes
//     out[m, n] = AF( float(sum_k A[m, k] * B[k, n]) * scale[n] )
// with A [M, K] activation codes, B [K, N] weight codes (the quantize-once
// [K, N] layout, unchanged), scale f32 [N] and an exact integer sum:
// integer sums do not depend on order, so the result is bit-identical to
// the plain version (for int8 codes while K * 127^2 < 2^31).
//
// Which mode runs where:
//  * the tensor-core core (tc::fxp_gemm_tc_kernel), every fused mode:
//    int8 codes, dense (fxp_gemm_fused) and MoE expert banks
//    (fxp_gemm_fused_batched: A [E, M, K], B [E, K, N], scale [E, N],
//    out [E, M, N], one launch for the bank); packed FxP4 weights, dense
//    (fxp_gemm_fused_packed) and banks (fxp_gemm_fused_batched_packed);
//    codes wider than 8 bits (FxP12/16 in int16: fxp_gemm_fused_wide);
//    and the raw code GEMMs, which write the int32 sums with no epilogue
//    (fxp_gemm_codes_int8 on int8 codes or packed FxP4 weights,
//    fxp_gemm_codes_int16). Each mode is its own instantiation of one
//    template;
//  * the CUDA cores (x32::fxp_gemm_x32_kernel): FxP24/32 codes in int32
//    (fxp_gemm_fused_x32), the PE's 1X FxP32 mode, with the same epilogue;
//  * a plain tiled int32 multiply-add (gemm_codes_wide_kernel): raw
//    int32 codes. As in the reference, the caller owns the overflow-free
//    bound K * qmax^2 < 2^31 past 8 bits.
//
// What bounds them: at decode M is the slot count (4), so every weight
// byte is used M times — about 2M integer operations per byte, far below
// the card's ~590 int8 operations per byte of memory bandwidth. Every
// mode is bound by reading B once (its bytes over 3.35 TB/s; a bank, the
// bytes of the experts its tokens route to); packed FxP4 weights halve
// those bytes. What keeps the small shapes from that bound is the fixed
// cost of a launch, of a block and of splitting K across blocks; the
// large ones stream B at what the card gives four-stage rings of copies
// (deeper rings were measured no faster).
//
// The tensor-core core:
//  * mma.sync m16n8k32 on s8/u8 operands with int32 accumulators, the
//    operands swapped: the weight's columns are the MMA's 16 rows and the
//    activation rows its 8 columns, so 4 decode rows pad half of a tile.
//    Row tiles of 8, 16 or 32 activation rows (16 at most for int16):
//    one to four MMA column tiles share each weight fragment, so a
//    16-row prefill chunk reads B once.
//  * The quantize-once [K, N] layout stays. B streams through a ring of
//    four stages in shared memory (128 k rows of 128 bytes: 128 int8, 64
//    int16 or, packed, 256 FxP4 columns, with the activation slice beside
//    it), filled by cp.async.cg 16-byte copies whose chunks are
//    XOR-swizzled so that a warp's loads hit distinct banks; each
//    thread's copy addresses are worked out once, before the k loop. A
//    lane reads 8 columns of 8 k rows and transposes them in registers
//    (transpose4) into k-contiguous fragments. A warp takes 64 columns
//    and its own k32 steps of each stage (for int16 codes all of them),
//    so every activation code is split once per block.
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
//  * Packed FxP4 weights: B holds nibble bytes [K, ldb], N <= 2 * ldb,
//    byte j of a row holding column 2j in its low nibble and 2j + 1 in
//    its high one (core.simd.pack's lane order). The H100 has no int4
//    tensor-core rate, so the nibbles become s8 fragments in registers,
//    as the TPU kernel's _unpack_nibbles does: a lane's word of a row
//    holds its 8 columns; one transpose4 of four rows' raw words gives,
//    per byte, the four k values of a column pair, and each such word
//    gives its low nibbles (the even column) shifted into the high half
//    of their bytes and its high nibbles (the odd one) masked in place.
//    A nibble in a byte's high half is 16 times its code as an s8 (16c
//    for c in -8..7), so each pair costs two logic operations and the
//    products sum to 16 times the exact sum, which an arithmetic shift
//    takes back off exactly before the warps' tiles are summed (at most
//    16 * 8 * 128 * 32768 = 2^29 in a block's int32 accumulator). The
//    columns then sit where an int8 lane's do, so the MMAs (s8.s8) and
//    the map from accumulators to output columns are the int8 codes'.
//    A packed block has eight warps, two to each group of 64 of its 256
//    columns, so that a stage's unpacking is shared as an int8 block's
//    transposes are and its epilogue owns one column a thread.
//  * Dense products: a block per (column tile, K slice, row tile). K is
//    split across blocks to fill the SMs at decode's few column tiles
//    (the wrapper's k_split: about one block per SM for int8 codes and
//    packed 32-row tiles, two for the rest, as measured): the warps'
//    partial tiles are summed in shared memory, each block adds its tile
//    into a workspace with atomics (int32; int64 for int16 codes, whose
//    unsigned long long atomics wrap exactly for signed values), and the
//    last block of a tile, counted by a semaphore, applies the epilogue. The
//    epilogue is bound by latency, not by bandwidth: each thread owns one
//    column, its scale read before the k loop, and issues all its loads
//    before its first store; the fused modes then stage the scaled sums
//    in shared memory and apply the AF in one rolled loop over the tile's
//    rows below M (the CORDIC code inlined once, not once per element a
//    thread owns).
//  * Expert banks (int8 and packed): a work item is (expert, row tile, K
//    slice, column tile), and A, B, scale, out and the workspace are
//    offset per expert. An item first ORs its A slice (16-byte loads);
//    when the slice holds no code (an expert no token routes to: at
//    decode 4 tokens x top-6 reach about 21 of 64 experts) it issues no
//    copies and no products, its tile is zero and it goes straight to its
//    epilogue, which writes AF(0). Packed banks run one item a block of
//    the grid. Int8 banks hand their items out: as many blocks as fit on
//    the card at once each claim the next item from a counter (a zeroed
//    word after the semaphores) until none is left, so the routed items
//    spread over the blocks that are free instead of landing where the
//    grid puts them. tools/gemm_tail_timeline.py times both on
//    DeepSeekMoE-16B's int8 banks: one H100 run gave the hand-out 2% less
//    time at the decode bank 2048 -> 1408, 4% more at 1408 -> 2048 and
//    1-2% less at the prefill and full banks, level over a layer's three
//    decode banks; what bounds a decode bank is the stream of its routed
//    items, all in flight at once, and the late start of the last ones.
//    On packed weights the claiming loop's registers leave two 256-thread
//    blocks on an SM instead of three, which cost the packed prefill and
//    full banks about 5%, so packed banks stay on the grid.
//
// The x32 kernel (int32 codes). A product of two codes reaches 2^62 and
// a sum over K rows needs more than 64 bits (~2^76 at K 13824), so the
// exact sum is held in 128 bits and rounded once to f32, to nearest even,
// in integer arithmetic: through f64 it would round twice. Each
// activation code a splits into a signed high half h = a >> 16 and an
// unsigned low half l = a & 0xFFFF; a lane sums h * w and l * w over its
// k rows in two int64 accumulators, one mad.wide.s32 each (|h w| < 2^46,
// |l w| < 2^47: exact for up to 2^16 rows, and a block's slice is at most
// kMaxKSplit = 32768), and h * 2^16 + l becomes a 128-bit sum only after
// the k loop. A lane takes 4 columns (one 16-byte load of a weight row)
// and 4 activation rows; the lanes of a warp hold 32 k of each row and
// pass them round by shuffles, so the kernel needs no shared memory in its
// k loop. A block's four warps take turns over 32-row chunks of its K
// slice on the same 128 columns and sum in shared memory. Split K: each
// block writes its slice's 128-bit partials to a slot of its own (no
// atomics, nothing zeroed), and the last block of a tile, counted by a
// semaphore, adds the slots. With 2 mad.wide a product, the decode shapes
// (4 rows) sit near both the bytes bound and the CUDA cores' integer
// rate; the tensor cores (16 byte-plane products of 4 planes) are not
// used.
//
// Not yet: wgmma and TMA (at M <= 32 these shapes are bound by bytes, far
// below mma.sync's integer rate); a balanced (stream-K) split of K, so
// that a dense grid's last wave does not leave SMs idle for the second
// half of the k loop; bulk asynchronous reductions of the split's tiles.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "cordic.cuh"

namespace {

constexpr int kThreads = 256;      // the int32 code GEMM's block
constexpr int kWarps = kThreads / 32;

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


// ---------------------------------------------------------------------------
// The tensor-core core: byte planes on mma.sync m16n8k32 (s8/u8)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRowBytes = 128;         // a stage's weight row: 128 int8, 64
                                       // int16 or 256 packed FxP4 codes
constexpr int kBK = 128;               // k rows per stage
constexpr int kStages = 4;             // the ring of stages
// K rows per block: each int32 plane partial stays exact
// (2 * 128 * 255 * 32768 < 2^31)
constexpr int kMaxKSplitWide = 32768;

// A block over codes T (or, kPacked, FxP4 nibble bytes) with MT
// activation rows: kBN output columns in groups of 64, one group per
// warp, the warps of a group taking turns over a stage's k32 steps; four
// warps, eight for packed weights (two to each group of their 256
// columns). Shared memory per stage: kBK weight rows of kRowBytes, then
// MT activation rows of kBK codes (padded by 16 codes, so that a warp's
// fragment loads hit distinct banks); after the k loop the same bytes
// hold the warps' partial tiles and the tile's scaled sums.
template <bool kPacked>
constexpr int kThreadsOf = kPacked ? 256 : 128;

template <typename T, int MT, bool kPacked = false>
struct Shape {
  static_assert(!kPacked || sizeof(T) == 1, "packed weights are bytes");
  static constexpr int kThreads = kThreadsOf<kPacked>;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRowCodes = kRowBytes / sizeof(T);  // as stored
  static constexpr int kBN = kPacked ? 2 * kRowBytes : kRowCodes;
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
  // then the tile's scaled sums [MT][kBN] f32, for the AF pass
  static constexpr int kFinBytes = MT * kBN * 4;
  static constexpr int kSmem = kStages * kStageBytes > kRedBytes + kFinBytes
                                   ? kStages * kStageBytes
                                   : kRedBytes + kFinBytes;
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
// (k rows k0 + kBK s ..): rows past k1, weight elements past a row's `ldb`
// and activation rows past M are zero. B's rows are `ldb` elements apart
// (N codes, or a packed weight's bytes), the block's first element of a
// row is `b0`. `vec` bit 0 / bit 1: B's / A's rows are 16-byte aligned
// (then cp.async copies, else plain loads of single elements).
template <typename T, int MT, bool kPacked>
struct CopyPlan {
  using S = Shape<T, MT, kPacked>;
  static constexpr int kPer = 16 / sizeof(T);          // codes per chunk
  static constexpr int kWCols = kRowBytes / 16;
  static constexpr int kWRows = S::kThreads / kWCols;  // weight rows a pass
  static constexpr int kACols = kBK / kPer;
  static constexpr int kARows = S::kThreads / kACols;  // activation rows
  static_assert(kWRows % 4 == 0, "a pass keeps the rows' swizzle");

  const T* A;
  const T* B;
  int M, K, ldb, m0, b0, k0, k1, vec, tid;
  int wr, wc, ar, ac, wdst, adst;
  size_t wsrc, asrc;                 // element offsets of stage 0's chunks

  __device__ __forceinline__ CopyPlan(const T* A_, const T* B_, int M_,
                                      int K_, int ldb_, int m0_, int b0_,
                                      int k0_, int k1_, int vec_, int tid_)
      : A(A_), B(B_), M(M_), K(K_), ldb(ldb_), m0(m0_), b0(b0_), k0(k0_),
        k1(k1_), vec(vec_), tid(tid_), wr(tid_ / kWCols), wc(tid_ % kWCols),
        ar(tid_ / kACols), ac(tid_ % kACols) {
    // row wr + kWRows q has row wr's swizzle: (kWRows q >> 2) & 3 == 0
    wdst = w_off(wr, 16 * wc);
    adst = S::kWBytes + ar * S::kAStride + 16 * ac;
    wsrc = static_cast<size_t>(k0 + wr) * ldb + b0 + wc * kPer;
    asrc = static_cast<size_t>(m0 + ar) * K + k0 + ac * kPer;
  }

  __device__ __forceinline__ void issue(unsigned char* st, int s) const {
    const int kb = k0 + s * kBK;
    if (vec & 1) {
      const bool col = b0 + wc * kPer < ldb;
#pragma unroll
      for (int q = 0; q < kBK / kWRows; ++q) {
        const bool ok = col && kb + wr + kWRows * q < k1;
        cp_async16(st + wdst + kWRows * q * kRowBytes,
                   B + (ok ? wsrc + static_cast<size_t>(s * kBK + kWRows * q)
                                        * ldb : 0), ok);
      }
    } else {
      for (int i = tid; i < kBK * S::kRowCodes; i += S::kThreads) {
        const int r = i / S::kRowCodes;
        const int c = i - r * S::kRowCodes;
        const int k = kb + r;
        const T v = (k < k1 && b0 + c < ldb)
            ? B[static_cast<size_t>(k) * ldb + b0 + c] : T(0);
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
      for (int i = tid; i < MT * kBK; i += S::kThreads) {
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

// Whether rows m0.. (at most MT, those below M) of A hold a nonzero code
// in k0..k1, for thread `tid` of kThreads: 16-byte loads when A's rows
// are aligned (`vec` bit 1; then K, k0 and k1 are multiples of 16 codes),
// else code by code.
template <typename T, int MT, int kThreads>
__device__ __forceinline__ bool any_code(const T* A, int M, int K, int m0,
                                         int k0, int k1, int vec, int tid) {
  const int rows = min(MT, M - m0);
  unsigned v = 0;
  if (vec & 2) {
    constexpr int kPer = 16 / sizeof(T);
    const int chunks = (k1 - k0) / kPer;
    for (int i = tid; i < rows * chunks; i += kThreads) {
      const int m = i / chunks;
      const uint4 c = __ldg(reinterpret_cast<const uint4*>(
                                A + static_cast<size_t>(m0 + m) * K + k0) +
                            (i - m * chunks));
      v |= c.x | c.y | c.z | c.w;
    }
  } else {
    const int cols = k1 - k0;
    for (int i = tid; i < rows * cols; i += kThreads) {
      const int m = i / cols;
      v |= A[static_cast<size_t>(m0 + m) * K + k0 + (i - m * cols)] != 0;
    }
  }
  return v != 0;
}

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

// Lane (g, t), packed weights: its word of weight row r0 + 16h + 4t + j
// holds columns 8g..8g+7, byte b columns 8g + 2b (low nibble) and
// 8g + 2b + 1 (high). transpose4 of the four rows' words gives each byte's
// four k values in a word; each nibble, moved to the high half of its
// byte, is 16 times its code as an int8 (16c for c in -8..7), so two
// logic operations give col[h][2b] (low nibbles, shifted up) and
// col[h][2b + 1] (high nibbles, masked), where transpose_rows puts an
// int8 lane's columns. The products then sum to 16 times the exact sum.
__device__ __forceinline__ void unpack_rows(const unsigned (&r)[4],
                                            int (&col)[8]) {
  int pairs[4];
  transpose4(r, pairs);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const unsigned p = static_cast<unsigned>(pairs[b]);
    col[2 * b] = static_cast<int>((p << 4) & 0xF0F0F0F0u);
    col[2 * b + 1] = static_cast<int>(p & 0xF0F0F0F0u);
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
template <typename T, int MT, bool kPacked>
__device__ __forceinline__ void k32_step(
    const unsigned char* st, int r0, int wl, int al,
    int (&acc)[kPlanes<T>][4][MT / 8][4]) {
  using S = Shape<T, MT, kPacked>;
  constexpr bool kWide = sizeof(T) == 2;
  constexpr int kP = kWide ? 2 : 1;          // byte planes of a code
  const unsigned char* w = st + wl + r0 * kRowBytes;
  // col[p][h][c]: rows r0 + 16h + 4t .. +3 of column c0 + 8g + c, plane p
  // (int16: 0 the high bytes, 1 the low bytes)
  int col[kP][2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (kPacked) {
      unsigned r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j] = *reinterpret_cast<const unsigned*>(w + (16 * h + j) *
                                                  kRowBytes);
      }
      unpack_rows(r, col[0][h]);
    } else {
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

// A block's work item: column tile x, K slice y and z (a bank's expert
// times its row tiles plus the row tile) of gx column tiles and gy slices.
struct Item {
  int x, y, z, gx, gy;
};

// Item `it` of the product. kPacked: B holds FxP4 nibble bytes [K, ldb]
// (N <= 2 ldb); else codes T [K, N] (ldb = N). kBank: E such products, z
// walking (expert, row tile), A [E, M, K], B [E, K, ldb], scale [E, N],
// out and ws [E, M, N]. counters: one semaphore per (z, x) when K is
// split.
template <typename T, int MT, bool kRaw, bool kPacked, bool kBank>
__device__ __forceinline__ void run_item(
    const Item it, const T* __restrict__ A, const T* __restrict__ B,
    const float* __restrict__ scale, void* __restrict__ out_,
    typename Shape<T, MT, kPacked>::Acc* __restrict__ ws,
    unsigned* __restrict__ counters, int M, int K, int N, int ldb, int kps,
    int vec, int af, int lv_n, const CordicParams& cp) {
  using S = Shape<T, MT, kPacked>;
  using Acc = typename S::Acc;
  using Out = typename std::conditional<kRaw, int, float>::type;
  constexpr int kThreads = S::kThreads;
  constexpr int kBN = S::kBN;
  constexpr int NT = MT / 8;                 // MMA column tiles (rows of A)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  Out* out = static_cast<Out*>(out_);
  int m0 = it.z * MT;
  if constexpr (kBank) {
    const int m_tiles = (M + MT - 1) / MT;
    const int expert = it.z / m_tiles;
    A += static_cast<size_t>(expert) * M * K;
    B += static_cast<size_t>(expert) * K * ldb;
    scale += static_cast<size_t>(expert) * N;
    out += static_cast<size_t>(expert) * M * N;
    ws += static_cast<size_t>(expert) * M * N;
    m0 = (it.z - expert * m_tiles) * MT;
  }
  const int n0 = it.x * kBN;
  const int k0 = it.y * kps;
  const int k1 = min(K, k0 + kps);
  int steps = (k1 - k0 + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int group = warp % S::kGroups;       // columns 64 group ..
  const int kwarp = warp / S::kGroups;       // k32 steps kwarp + kKWarps j
  // the epilogue: thread tid owns element e = tid + kThreads j of the
  // [MT][kBN] tile, row e / kBN and column e % kBN (j < kRows): one
  // column, whose scale is read before the k loop
  static_assert(kBN <= kThreads, "a thread owns one column");
  constexpr int kRows = MT * kBN / kThreads;
  const int cn = n0 + tid % kBN;
  float sc = 0.f;
  if constexpr (!kRaw) {
    if (cn < N) sc = __ldg(scale + cn);
  }
  if constexpr (kBank) {
    // a slice of zero activation codes adds nothing: no copies, no
    // products, a zero tile
    if (!__syncthreads_or(any_code<T, MT, kThreads>(A, M, K, m0, k0, k1, vec,
                                                    tid))) {
      steps = 0;
    }
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

  const CopyPlan<T, MT, kPacked> plan(A, B, M, K, ldb, m0,
                                      kPacked ? n0 / 2 : n0, k0, k1, vec,
                                      tid);
  // the lane's fragment offsets (see k32_step): the byte of column
  // c0 + 8g in row 4t, swizzled, and activation row g at k 4t
  const int cb = (64 * group + 8 * g) * sizeof(T) / (kPacked ? 2 : 1);
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
      k32_step<T, MT, kPacked>(st, 32 * (kwarp + S::kKWarps * j), wl, al,
                               acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                         // the ring is free

  // the warps' partial tiles [kwarp][MT][kBN] (rows kRedStride apart):
  // accumulator e of MMA tile i, column tile nt is output column
  // 64 group + 8g + 2i + (e >> 1), row nt * 8 + 2t + (e & 1); packed
  // weights' sums are 16 times the exact sum (see unpack_rows), a
  // multiple of 16 below 2^31 in magnitude (16 * 8 * 128 * 32768 = 2^29),
  // so an arithmetic shift takes the factor back off exactly
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
          v = kPacked ? acc[0][i][nt][e] >> 4 : acc[0][i][nt][e];
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
    const int e = tid + kThreads * j;
    total[j] = 0;
#pragma unroll
    for (int w = 0; w < S::kKWarps; ++w) {
      total[j] += red[(w * MT + e / kBN) * S::kRedStride + e % kBN];
    }
  }
  // element j's offset in out and ws, or -1 past M or N
  auto offset = [&](int j) -> long long {
    const int row = m0 + (tid + kThreads * j) / kBN;
    return (row < M && cn < N) ? static_cast<long long>(row) * N + cn : -1;
  };
  // the raw GEMMs write the low 32 bits of the sum (the wrapping int32
  // sum); the fused modes keep the scaled sum for the AF pass
  float* fin = reinterpret_cast<float*>(smem + S::kRedBytes);
  auto store = [&](int j, Acc v) {
    if constexpr (kRaw) {
      const long long o = offset(j);
      if (o >= 0) out[o] = static_cast<int>(static_cast<unsigned>(v));
    } else {
      fin[tid + kThreads * j] = __fmul_rn(__ll2float_rn(v), sc);
    }
  };
  // the AF pass of the fused modes: one loop over the tile's rows below M,
  // kept rolled so that the CORDIC code is inlined once, its stores
  // coalesced
  auto finish = [&]() {
    if constexpr (!kRaw) {
      __syncthreads();
      const int rows = min(MT, M - m0);
#pragma unroll 1
      for (int e = tid; e < rows * kBN; e += kThreads) {
        const int c = n0 + e % kBN;
        if (c < N) {
          out[static_cast<size_t>(m0 + e / kBN) * N + c] =
              apply_af(fin[e], af, cp, lv_n);
        }
      }
    }
  };
  if (it.gy == 1) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) store(j, total[j]);
    finish();
    return;
  }
  // split K: add the tile into the workspace, then let the last block of
  // the tile apply the epilogue
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const long long o = offset(j);
    if (o >= 0 && total[j] != 0) {
      if constexpr (sizeof(T) == 2) {
        atomicAdd(reinterpret_cast<unsigned long long*>(ws + o),
                  static_cast<unsigned long long>(total[j]));
      } else {
        atomicAdd(ws + o, total[j]);
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
        atomicAdd(&counters[it.z * it.gx + it.x], 1u);
    is_last = prev + 1 == static_cast<unsigned>(it.gy);
    if (is_last) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
  if (!is_last) return;
  // every load before the first store: one round trip to the L2
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const long long o = offset(j);
    total[j] = o >= 0 ? __ldcg(ws + o) : Acc(0);
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) store(j, total[j]);
  finish();
}

// Whether a launch hands its items out from a counter (int8 expert
// banks: see the header) or runs one item a block of its grid
template <bool kPacked, bool kBank>
constexpr bool kHandOut = kBank && !kPacked;

// The grid's items, or with kHandOut `items` of them claimed in order from
// the counter after the semaphores (counters[tiles], tiles = items / gy
// when K is split, else counters[0]), zeroed at launch, by as many blocks
// as fit on the card at once.
template <typename T, int MT, bool kRaw, bool kPacked = false,
          bool kBank = false>
__global__ void __launch_bounds__(kThreadsOf<kPacked>)
fxp_gemm_tc_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   const float* __restrict__ scale, void* __restrict__ out_,
                   typename Shape<T, MT, kPacked>::Acc* __restrict__ ws,
                   unsigned* __restrict__ counters, int M, int K, int N,
                   int ldb, int kps, int vec, int af, int lv_n, int items,
                   CordicParams cp) {
  if constexpr (kHandOut<kPacked, kBank>) {
    const int gx = (N + Shape<T, MT, kPacked>::kBN - 1) /
                   Shape<T, MT, kPacked>::kBN;
    const int gy = (K + kps - 1) / kps;
    unsigned* const next = counters + (gy > 1 ? items / gy : 0);
    __shared__ int item;
    for (;;) {
      __syncthreads();          // the last item is done with shared memory
      if (threadIdx.x == 0) item = static_cast<int>(atomicAdd(next, 1u));
      __syncthreads();
      const int i = item;
      if (i >= items) return;
      run_item<T, MT, kRaw, kPacked, kBank>(
          Item{i % gx, i / gx % gy, i / (gx * gy), gx, gy}, A, B, scale,
          out_, ws, counters, M, K, N, ldb, kps, vec, af, lv_n, cp);
    }
  } else {
    run_item<T, MT, kRaw, kPacked, kBank>(
        Item{static_cast<int>(blockIdx.x), static_cast<int>(blockIdx.y),
             static_cast<int>(blockIdx.z), static_cast<int>(gridDim.x),
             static_cast<int>(gridDim.y)},
        A, B, scale, out_, ws, counters, M, K, N, ldb, kps, vec, af, lv_n,
        cp);
  }
}

template <typename T, int MT, bool kRaw, bool kPacked, bool kBank>
cudaError_t launch(const T* a, const T* b, const float* scale, void* out,
                   typename Shape<T, MT, kPacked>::Acc* ws,
                   unsigned* counters, int E, int M, int K, int N, int ldb,
                   int kps, int vec, int af, int lv_n,
                   const CordicParams& cp, cudaStream_t stream) {
  using S = Shape<T, MT, kPacked>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fxp_gemm_tc_kernel<T, MT, kRaw, kPacked, kBank>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + S::kBN - 1) / S::kBN, (K + kps - 1) / kps,
            E * ((M + MT - 1) / MT));
  const int items = static_cast<int>(grid.x * grid.y * grid.z);
  if constexpr (kHandOut<kPacked, kBank>) {
    // the blocks resident at once on the card (one card per process)
    static const int resident = [] {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fxp_gemm_tc_kernel<T, MT, kRaw, kPacked, kBank>,
          S::kThreads, S::kSmem);
      return sms * per_sm;
    }();
    grid = dim3(resident > 0 && resident < items ? resident : items);
  }
  fxp_gemm_tc_kernel<T, MT, kRaw, kPacked, kBank>
      <<<grid, S::kThreads, S::kSmem, stream>>>(
          a, b, scale, out, ws, counters, M, K, N, ldb, kps, vec, af, lv_n,
          items, cp);
  return cudaGetLastError();
}

// Row tiles of 8, 16 or (int8 codes and packed weights) 32 activation
// rows: one to four MMA column tiles share each weight fragment. E > 1
// only for banks; ldb: B's row in elements (N unless packed).
template <typename T, bool kRaw, bool kPacked = false, bool kBank = false>
int dispatch(const T* a, const T* b, const float* scale, void* out,
             typename Shape<T, 8>::Acc* ws, unsigned* counters, int E, int M,
             int K, int N, int ldb, int kps, int vec, int af, int lv_n,
             const CordicParams* cp, void* stream) {
  static_assert(!(kRaw && kBank), "banks have the fused epilogue");
  constexpr int kMaxMT = sizeof(T) == 1 ? 32 : 16;
  if (E <= 0 || (!kBank && E != 1) || M <= 0 || N <= 0 || K <= 0 ||
      kps <= 0 || kps % kBK != 0 || kps > kMaxKSplitWide ||
      (K + kps - 1) / kps > 65535 ||
      (kPacked ? (ldb <= 0 || N > 2 * ldb) : ldb != N) ||
      static_cast<long long>(E) * ((M + kMaxMT - 1) / kMaxMT) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 8) {
    return static_cast<int>(launch<T, 8, kRaw, kPacked, kBank>(
        a, b, scale, out, ws, counters, E, M, K, N, ldb, kps, vec, af, lv_n,
        *cp, s));
  }
  if constexpr (kMaxMT == 32) {
    if (M > 16) {
      return static_cast<int>(launch<T, 32, kRaw, kPacked, kBank>(
          a, b, scale, out, ws, counters, E, M, K, N, ldb, kps, vec, af,
          lv_n, *cp, s));
    }
  }
  return static_cast<int>(launch<T, 16, kRaw, kPacked, kBank>(
      a, b, scale, out, ws, counters, E, M, K, N, ldb, kps, vec, af, lv_n,
      *cp, s));
}

}  // namespace tc

// ---------------------------------------------------------------------------
// FxP24/32 codes in int32 on the CUDA cores (see the header)
// ---------------------------------------------------------------------------
namespace x32 {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 4;            // a lane's columns: one 16-byte load
constexpr int kBN = 32 * kCols;     // a block's columns
constexpr int kMT = 4;              // activation rows of a row tile
constexpr int kGroup = 8;           // weight rows a lane loads at once
constexpr int kMaxKSplit = 32768;   // k rows of a block: the int64 sums of
                                    // l * w stay exact (< 2^16 rows)

// A signed 128-bit integer, hi * 2^64 + lo.
struct I128 {
  long long hi;
  unsigned long long lo;
};

__device__ __forceinline__ I128 add128(I128 a, I128 b) {
  I128 r;
  r.lo = a.lo + b.lo;
  r.hi = a.hi + b.hi + (r.lo < a.lo ? 1 : 0);
  return r;
}

// h * 2^16 + l
__device__ __forceinline__ I128 join(long long h, long long l) {
  return add128(I128{h >> 48, static_cast<unsigned long long>(h) << 16},
                I128{l >> 63, static_cast<unsigned long long>(l)});
}

// v rounded once to f32, to nearest even: |v| keeps its top 64 bits with
// every bit shifted out ORed into bit 0 (round to odd, 40 bits below
// f32's 24), which one conversion then rounds correctly; the power-of-two
// scale back is exact.
__device__ __forceinline__ float to_f32_rn(I128 v) {
  unsigned long long hi = static_cast<unsigned long long>(v.hi);
  unsigned long long lo = v.lo;
  const bool neg = v.hi < 0;
  if (neg) {
    lo = ~lo + 1ull;
    hi = ~hi + (lo == 0ull ? 1ull : 0ull);
  }
  float f;
  if (hi == 0ull) {
    f = __ull2float_rn(lo);
  } else {
    const int s = 64 - __clzll(static_cast<long long>(hi));   // 1..64
    const unsigned long long m =
        s == 64 ? (hi | (lo != 0ull ? 1ull : 0ull))
                : (hi << (64 - s)) | (lo >> s) |
                      ((lo << (64 - s)) != 0ull ? 1ull : 0ull);
    f = __fmul_rn(__ull2float_rn(m), __int_as_float((127 + s) << 23));
  }
  return neg ? -f : f;
}

__device__ __forceinline__ void mad_wide(long long& acc, int a, int b) {
  asm("mad.wide.s32 %0, %1, %2, %0;\n" : "+l"(acc) : "r"(a), "r"(b));
}

// Columns c0..c0+3 of weight row k (zero past k1 or N); `vec`: 16-byte
// loads (rows 16-byte aligned, N a multiple of 4).
__device__ __forceinline__ void load_row(const int* __restrict__ B, int k,
                                         int k1, int N, int c0, int vec,
                                         int (&b)[kCols]) {
  const int* row = B + static_cast<size_t>(k) * N + c0;
  if (vec) {
    int4 v = make_int4(0, 0, 0, 0);
    if (k < k1 && c0 < N) v = __ldg(reinterpret_cast<const int4*>(row));
    b[0] = v.x;
    b[1] = v.y;
    b[2] = v.z;
    b[3] = v.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      b[c] = (k < k1 && c0 + c < N) ? __ldg(row + c) : 0;
    }
  }
}

// Block (column tile x, K slice y, row tile z) of A int32 [M, K] @
// B int32 [K, N]: out f32 [M, N] = AF(f32(sum) * scale[N]). Split K
// (gridDim.y > 1): ws holds the slices' partials [gridDim.y][M][N] as
// (lo, hi) words, counters one semaphore per (z, x), zeroed.
__global__ void __launch_bounds__(kThreads, 3)
fxp_gemm_x32_kernel(const int* __restrict__ A, const int* __restrict__ B,
                    const float* __restrict__ scale, float* __restrict__ out,
                    unsigned long long* __restrict__ ws,
                    unsigned* __restrict__ counters, int M, int K, int N,
                    int kps, int vec, int af, int lv_n, CordicParams cp) {
  __shared__ long long red[kWarps][kMT][kBN][2];
  __shared__ float fin[kMT][kBN];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.z * kMT;
  const int k0 = blockIdx.y * kps;
  const int k1 = min(K, k0 + kps);
  const int c0 = n0 + kCols * lane;

  long long acc[2][kMT][kCols];          // [0]: h * w, [1]: l * w
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int r = 0; r < kMT; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[p][r][c] = 0;

  for (int kc = k0 + 32 * warp; kc < k1; kc += 32 * kWarps) {
    // lane j: the halves of A[m0 + r][kc + j]
    int ah[kMT], al[kMT];
#pragma unroll
    for (int r = 0; r < kMT; ++r) {
      const int k = kc + lane;
      const int a = (m0 + r < M && k < k1)
          ? __ldg(A + static_cast<size_t>(m0 + r) * K + k) : 0;
      ah[r] = a >> 16;
      al[r] = a & 0xFFFF;
    }
#pragma unroll
    for (int g = 0; g < 32; g += kGroup) {
      int b[kGroup][kCols];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        load_row(B, kc + g + i, k1, N, c0, vec, b[i]);
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
#pragma unroll
        for (int r = 0; r < kMT; ++r) {
          const int h = __shfl_sync(0xffffffffu, ah[r], g + i);
          const int l = __shfl_sync(0xffffffffu, al[r], g + i);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            mad_wide(acc[0][r][c], h, b[i][c]);
            mad_wide(acc[1][r][c], l, b[i][c]);
          }
        }
      }
    }
  }

  // the warps' sums, then thread tid owns column n0 + tid of the tile
#pragma unroll
  for (int r = 0; r < kMT; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      red[warp][r][kCols * lane + c][0] = acc[0][r][c];
      red[warp][r][kCols * lane + c][1] = acc[1][r][c];
    }
  __syncthreads();
  const int cn = n0 + tid;
  const int rows = min(kMT, M - m0);
  I128 v[kMT];
#pragma unroll
  for (int r = 0; r < kMT; ++r) {
    long long h = 0, l = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      h += red[w][r][tid][0];
      l += red[w][r][tid][1];
    }
    v[r] = join(h, l);
  }
  if (gridDim.y > 1) {
    // this slice's partials into its own slot, then the last block of the
    // tile (the fences as in the tensor-core core) adds every slot
    auto slot = [&](int y, int r) {
      return ws + 2 * ((static_cast<size_t>(y) * M + m0 + r) * N + cn);
    };
#pragma unroll
    for (int r = 0; r < kMT; ++r) {
      if (r < rows && cn < N) {
        unsigned long long* p = slot(blockIdx.y, r);
        p[0] = v[r].lo;
        p[1] = static_cast<unsigned long long>(v[r].hi);
      }
    }
    __syncthreads();
    if (tid == 0) {
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
      const unsigned prev =
          atomicAdd(&counters[blockIdx.z * gridDim.x + blockIdx.x], 1u);
      is_last = prev + 1 == gridDim.y;
      if (is_last) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    }
    __syncthreads();
    if (!is_last) return;
#pragma unroll
    for (int r = 0; r < kMT; ++r) {
      v[r] = I128{0, 0ull};
      if (r < rows && cn < N) {
        for (int y = 0; y < static_cast<int>(gridDim.y); ++y) {
          const unsigned long long* p = slot(y, r);
          v[r] = add128(v[r], I128{static_cast<long long>(__ldcg(p + 1)),
                                   __ldcg(p)});
        }
      }
    }
  }
  const float sc = cn < N ? __ldg(scale + cn) : 0.f;
#pragma unroll
  for (int r = 0; r < kMT; ++r) fin[r][tid] = __fmul_rn(to_f32_rn(v[r]), sc);
  // the AF in one rolled loop over the tile's rows (the CORDIC code
  // inlined once), each row's stores coalesced
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    if (cn < N) {
      out[static_cast<size_t>(m0 + r) * N + cn] =
          apply_af(fin[r][tid], af, cp, lv_n);
    }
  }
}

}  // namespace x32

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

// int8 codes on the tensor-core core: a [M, K], b [K, N]; kps a multiple
// of 128, at most 32768; when K is split (kps < K) ws int32 [M, N] and one
// counter per tile, zeroed; `vec` bit 0 / 1: b's / a's rows are 16-byte
// aligned.
extern "C" int fxp_gemm_fused(const int8_t* a, const int8_t* b,
                              const float* scale, float* out, int* ws,
                              unsigned* counters, int M, int K, int N, int kps,
                              int vec, int af, int lv_n,
                              const CordicParams* cp, void* stream) {
  return tc::dispatch<int8_t, false>(a, b, scale, out, ws, counters, 1, M, K,
                                     N, N, kps, vec, af, lv_n, cp, stream);
}

// int8 expert banks on the tensor-core core: a [E, M, K], b [E, K, N],
// scale [E, N], out [E, M, N]; kps and `vec` as for the dense entry, ws
// [E, M, N] and one counter per (expert, tile) when K is split.
extern "C" int fxp_gemm_fused_batched(const int8_t* a, const int8_t* b,
                                      const float* scale, float* out, int* ws,
                                      unsigned* counters, int E, int M, int K,
                                      int N, int kps, int vec, int af,
                                      int lv_n, const CordicParams* cp,
                                      void* stream) {
  return tc::dispatch<int8_t, false, false, true>(
      a, b, scale, out, ws, counters, E, M, K, N, N, kps, vec, af, lv_n, cp,
      stream);
}

// Packed FxP4 weights on the tensor-core core: b holds nibble bytes
// [K, ldb] (the int32 words of core.simd.pack seen as bytes), N <= 2 * ldb
// output columns; kps a multiple of 128, at most 32768; when K is split
// (kps < K) ws int32 [M, N] and one counter per tile, zeroed; `vec` bit
// 0 / 1: b's / a's rows are 16-byte aligned.
extern "C" int fxp_gemm_fused_packed(const int8_t* a, const int8_t* b,
                                     const float* scale, float* out, int* ws,
                                     unsigned* counters, int M, int K, int N,
                                     int ldb, int kps, int vec, int af,
                                     int lv_n, const CordicParams* cp,
                                     void* stream) {
  return tc::dispatch<int8_t, false, true>(a, b, scale, out, ws, counters, 1,
                                           M, K, N, ldb, kps, vec, af, lv_n,
                                           cp, stream);
}

// Packed FxP4 expert banks on the tensor-core core: a [E, M, K], b nibble
// bytes [E, K, ldb], N <= 2 * ldb, scale [E, N], out [E, M, N]; kps and
// `vec` as for the dense entry, ws [E, M, N] and one counter per (expert,
// tile) when K is split.
extern "C" int fxp_gemm_fused_batched_packed(const int8_t* a, const int8_t* b,
                                             const float* scale, float* out,
                                             int* ws, unsigned* counters,
                                             int E, int M, int K, int N,
                                             int ldb, int kps, int vec, int af,
                                             int lv_n, const CordicParams* cp,
                                             void* stream) {
  return tc::dispatch<int8_t, false, true, true>(
      a, b, scale, out, ws, counters, E, M, K, N, ldb, kps, vec, af, lv_n, cp,
      stream);
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
  return tc::dispatch<int16_t, false>(a, b, scale, out, ws, counters, 1, M, K,
                                      N, N, kps, vec, af, lv_n, cp, stream);
}

// FxP24/32 codes in int32 on the CUDA cores: a [M, K], b [K, N]; kps at
// most 32768; when K is split (kps < K) ws holds [K / kps][M][N] pairs of
// 64-bit words and counters one zeroed word per (row tile of 4, column
// tile of 128); `vec`: b's rows are 16-byte aligned and N a multiple of 4.
extern "C" int fxp_gemm_fused_x32(const int32_t* a, const int32_t* b,
                                  const float* scale, float* out,
                                  unsigned long long* ws, unsigned* counters,
                                  int M, int K, int N, int kps, int vec,
                                  int af, int lv_n, const CordicParams* cp,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || kps <= 0 || kps > x32::kMaxKSplit ||
      (K + kps - 1) / kps > 65535 || (M + x32::kMT - 1) / x32::kMT > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((N + x32::kBN - 1) / x32::kBN, (K + kps - 1) / kps,
            (M + x32::kMT - 1) / x32::kMT);
  x32::fxp_gemm_x32_kernel<<<grid, x32::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      a, b, scale, out, ws, counters, M, K, N, kps, vec, af, lv_n, *cp);
  return static_cast<int>(cudaGetLastError());
}

// Raw int32 products on the tensor-core core, no epilogue: int8 codes
// b [K, N], or with packed = 1 nibble bytes b [K, ldb] (N <= 2 * ldb); ws
// int32, kps and `vec` as for the wide mode.
extern "C" int fxp_gemm_codes_int8(const int8_t* a, const int8_t* b, int* out,
                                   int* ws, unsigned* counters, int M, int K,
                                   int N, int ldb, int packed, int kps,
                                   int vec, void* stream) {
  return packed
      ? tc::dispatch<int8_t, true, true>(a, b, nullptr, out, ws, counters, 1,
                                         M, K, N, ldb, kps, vec, 0, 0,
                                         &kNoCordic, stream)
      : tc::dispatch<int8_t, true>(a, b, nullptr, out, ws, counters, 1, M, K,
                                   N, N, kps, vec, 0, 0, &kNoCordic, stream);
}

// Raw products of int16 codes on the tensor-core core: the low 32 bits of
// the exact sum (ws int64, as for the wide mode).
extern "C" int fxp_gemm_codes_int16(const int16_t* a, const int16_t* b,
                                    int* out, long long* ws,
                                    unsigned* counters, int M, int K, int N,
                                    int kps, int vec, void* stream) {
  return tc::dispatch<int16_t, true>(a, b, nullptr, out, ws, counters, 1, M,
                                     K, N, N, kps, vec, 0, 0, &kNoCordic,
                                     stream);
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
