// cordic_softmax — the Flex-PE CORDIC row softmax op, the whole op in one
// launch, written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/cordic_softmax/cordic_softmax.py,
// cordic_softmax_pallas (body _kernel, repeat_iters=True), and the two
// per-tensor FxP fake-quants the op wraps it in
// (src/repro/kernels/cordic_softmax/ops.py). For x [M, N] in bf16 or f32:
//   xs  = snap(float(x))        per tensor, max |x| over all rows
//   per row: m = max, e = hr_exp(xs - m), s = sum(e), y = lv_div(e, s)
//                               (`cordic.cuh`; |e| <= s keeps every
//                               quotient inside the LV convergence range)
//   out = cast(snap(y))         per tensor again, max |y|; bf16 RNE
// The snaps are those of `fxp_snap.cuh`, the same operations as the plain
// op's PyTorch on the card: bit-equal to `cordic_softmax_reference`.
//
// The sum is taken in one fixed order, which the plain version
// (`cordic_softmax_plain`, `warp_row_sum`) repeats operation for
// operation: lane l of the row's warp adds e[l], e[l+32], e[l+64], ... in
// turn, starting from 0; then five xor-shuffle steps (offsets 16, 8, 4, 2,
// 1) each add the partner lane's value, which leaves the same total in
// every lane (f32 addition commutes). A different order moves the sum by
// an ulp, and the LV divide turns that into a 2^-lv step of a probability.
// The row max propagates NaN, as torch.amax does.
//
// What bounds it: the MoE router's rows are 64 wide and there are 4-16 of
// them, a few KB in all, about 150 f32 operations an element: some
// nanoseconds of the card's bytes or operations. The op used to take 21
// device records (the kernel and 20 PyTorch ops of the snaps); now the
// floor is one launch, and at these sizes two barriers of one block.
//
// What the design does about it: one cooperative launch of 512 threads a
// block (16 warps), one warp per row, three phases meeting at two grid
// barriers as in `cordic_af.cu`. Each lane holds its columns of up to
// 16 / K rows in registers (K = 1, 2, 4, 8 or 16 columns a lane, N <=
// 32 K): x is read once, exp and the divide run once per element. Rows
// fill one warp each before a warp takes a second, so the router's 4 or
// 16 rows run in one block, whose barriers are __syncthreads. Rows wider
// than 512 columns, or more rows than the resident grid holds, take the
// fallback (K = 0): a warp per row walks the row from memory (L1) in
// three passes (max; exp and sum; exp again and divide) in each phase, so
// rows of any width run without shared memory; recomputing hr_exp gives
// the same bits. Without a precision the fallback runs once, as an
// ordinary launch.
#include "cordic.cuh"
#include "fxp_snap.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kHeld = 16;                    // values a lane holds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max_nan(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = max_nan(m, __shfl_xor_sync(kFull, m, off));
  }
  return m;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  }
  return s;
}

constexpr float kNegInf = -__builtin_huge_valf();

// one row by one warp from memory: calls emit(column, softmax value)
template <typename T, typename Emit>
__device__ __forceinline__ void row_from_memory(const T* xr, int n, int lane,
                                                bool snap_on, float s_in,
                                                SnapGrid g, int lv_n,
                                                const CordicParams& cp,
                                                Emit emit) {
  auto in = [&](int j) {
    const float v = load_f32(xr + j);
    return snap_on ? snap(v, s_in, g) : v;
  };
  float m = kNegInf;
  for (int j = lane; j < n; j += 32) m = max_nan(m, in(j));
  m = warp_max_nan(m);
  float s = 0.f;
  for (int j = lane; j < n; j += 32) {
    s = __fadd_rn(s, hr_exp(__fsub_rn(in(j), m), cp));
  }
  s = warp_sum(s);
  for (int j = lane; j < n; j += 32) {
    emit(j, lv_div(hr_exp(__fsub_rn(in(j), m), cp), s, lv_n));
  }
}

// K columns a lane (0: the fallback); a warp holds up to kHeld / K rows,
// row q * warps-in-grid + warp for q < rpw
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
cordic_softmax_kernel(const T* __restrict__ x, T* __restrict__ out,
                      unsigned* __restrict__ slots, int rows, int n, int rpw,
                      int lv_n, int snap_on, SnapGrid g, CordicParams cp) {
  __shared__ unsigned red[32];
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int warps = gridDim.x * kWarps;
  if constexpr (K > 0) {
    constexpr int R = kHeld / K;
    float v[R][K];
    unsigned m = 0u;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = q * warps + warp;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = lane + 32 * k;
        v[q][k] = q < rpw && r < rows && c < n
                      ? load_f32(x + static_cast<size_t>(r) * n + c) : 0.f;
        m = max(m, abs_bits(v[q][k]));
      }
    }
    const float s_in = snap_scale(grid_max_bits(m, slots, red), g.qmax);
    m = 0u;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = q * warps + warp;
      if (q < rpw && r < rows) {             // the whole warp, or none of it
        float mx = kNegInf;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (lane + 32 * k < n) {
            v[q][k] = snap(v[q][k], s_in, g);
            mx = max_nan(mx, v[q][k]);
          }
        }
        mx = warp_max_nan(mx);
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (lane + 32 * k < n) {
            v[q][k] = hr_exp(__fsub_rn(v[q][k], mx), cp);
            s = __fadd_rn(s, v[q][k]);
          }
        }
        s = warp_sum(s);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (lane + 32 * k < n) {
            v[q][k] = lv_div(v[q][k], s, lv_n);
            m = max(m, abs_bits(v[q][k]));
          }
        }
      }
    }
    const float s_out =
        snap_scale(grid_max_bits(m, slots + gridDim.x, red), g.qmax);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = q * warps + warp;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = lane + 32 * k;
        if (q < rpw && r < rows && c < n) {
          store_f32(out + static_cast<size_t>(r) * n + c,
                    snap(v[q][k], s_out, g));
        }
      }
    }
  } else {
    float s_in = 0.f, s_out = 0.f;
    if (snap_on) {
      const long long total = static_cast<long long>(rows) * n;
      unsigned m = 0u;
      for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
           i < total; i += static_cast<long long>(gridDim.x) * kThreads) {
        m = max(m, abs_bits(load_f32(x + i)));
      }
      s_in = snap_scale(grid_max_bits(m, slots, red), g.qmax);
      m = 0u;
      for (int r = warp; r < rows; r += warps) {
        row_from_memory(x + static_cast<size_t>(r) * n, n, lane, true, s_in,
                        g, lv_n, cp,
                        [&](int, float y) { m = max(m, abs_bits(y)); });
      }
      s_out = snap_scale(grid_max_bits(m, slots + gridDim.x, red), g.qmax);
    }
    for (int r = warp; r < rows; r += warps) {
      T* orow = out + static_cast<size_t>(r) * n;
      row_from_memory(x + static_cast<size_t>(r) * n, n, lane, snap_on != 0,
                      s_in, g, lv_n, cp, [&](int j, float y) {
                        store_f32(orow + j, snap_on ? snap(y, s_out, g) : y);
                      });
    }
  }
}

template <typename T, int K>
int resident() {
  static const int r =
      resident_blocks(cordic_softmax_kernel<T, K>, kThreads);
  return r;
}

template <typename T, int K>
cudaError_t launch(const void* x, void* out, unsigned* slots, int grid,
                   bool coop, int rows, int n, int rpw, int lv_n, int snap_on,
                   SnapGrid g, const CordicParams& cp, cudaStream_t stream) {
  return launch_op(cordic_softmax_kernel<T, K>, grid, kThreads, coop, stream,
                   static_cast<const T*>(x), static_cast<T*>(out), slots,
                   rows, n, rpw, lv_n, snap_on, g, cp);
}

// rows a warp holds so that the resident grid covers `rows` (one each
// while the grid allows), or 0 when more than kHeld / K would be needed
template <typename T, int K>
int rows_per_warp(int rows) {
  const long long warps = static_cast<long long>(resident<T, K>()) * kWarps;
  if (warps <= 0) return 0;
  const long long rpw = (rows + warps - 1) / warps;
  return rpw <= kHeld / K ? static_cast<int>(rpw) : 0;
}

template <typename T>
cudaError_t run(const void* x, void* out, unsigned* slots, int slot_cap,
                int rows, int n, int lv_n, int snap_on, SnapGrid g,
                const CordicParams& cp, cudaStream_t stream) {
  int k = 0, rpw = 0;
  if (snap_on && n <= 32 * kHeld) {
    k = n <= 32 ? 1 : n <= 64 ? 2 : n <= 128 ? 4 : n <= 256 ? 8 : 16;
    switch (k) {
      case 1: rpw = rows_per_warp<T, 1>(rows); break;
      case 2: rpw = rows_per_warp<T, 2>(rows); break;
      case 4: rpw = rows_per_warp<T, 4>(rows); break;
      case 8: rpw = rows_per_warp<T, 8>(rows); break;
      default: rpw = rows_per_warp<T, 16>(rows); break;
    }
    if (rpw == 0) k = 0;
  }
  const long long per_block = static_cast<long long>(kWarps) * (k ? rpw : 1);
  long long grid = (rows + per_block - 1) / per_block;
  const long long cap = resident<T, 0>();
  if (k == 0 && grid > cap) grid = cap;
  if (snap_on && 2 * grid > slot_cap) return cudaErrorInvalidValue;
  const bool coop = snap_on != 0;
  const int gi = static_cast<int>(grid);
  switch (k) {
    case 1: return launch<T, 1>(x, out, slots, gi, coop, rows, n, rpw, lv_n,
                                snap_on, g, cp, stream);
    case 2: return launch<T, 2>(x, out, slots, gi, coop, rows, n, rpw, lv_n,
                                snap_on, g, cp, stream);
    case 4: return launch<T, 4>(x, out, slots, gi, coop, rows, n, rpw, lv_n,
                                snap_on, g, cp, stream);
    case 8: return launch<T, 8>(x, out, slots, gi, coop, rows, n, rpw, lv_n,
                                snap_on, g, cp, stream);
    case 16: return launch<T, 16>(x, out, slots, gi, coop, rows, n, rpw,
                                  lv_n, snap_on, g, cp, stream);
    default: return launch<T, 0>(x, out, slots, gi, coop, rows, n, 0, lv_n,
                                 snap_on, g, cp, stream);
  }
}

}  // namespace

// x, out [rows, n] row-major; dtype 0: f32, 1: bf16. snap_on: the
// per-tensor snaps onto [qmin, qmax] (slots: slot_cap words of workspace,
// two per block).
extern "C" int cordic_softmax_op(const void* x, void* out, unsigned* slots,
                                 int slot_cap, int rows, int n, int dtype,
                                 int lv_n, int snap_on, float qmin,
                                 float qmax, const CordicParams* cp,
                                 void* stream) {
  if (rows <= 0 || n <= 0 || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SnapGrid g{qmin, qmax};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? run<float>(x, out, slots, slot_cap, rows, n, lv_n,
                              snap_on, g, *cp, s)
                 : run<__nv_bfloat16>(x, out, slots, slot_cap, rows, n, lv_n,
                                      snap_on, g, *cp, s));
}
