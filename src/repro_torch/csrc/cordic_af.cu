// cordic_af — the Flex-PE CORDIC activation op, the whole op in one launch,
// written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/cordic_af/cordic_af.py, cordic_af_pallas
// (body _af_block, repeat_iters=True), and the two per-tensor FxP
// fake-quants the op wraps it in (src/repro/kernels/cordic_af/ops.py).
// For x of n elements in bf16 or f32:
//   xs  = snap(float(x))          per tensor, max |x| over all of x
//   y   = AF(xs)                  relu, sigmoid, tanh, silu, gelu or exp:
//                                 the HR exp and LV divide of `cordic.cuh`
//   out = cast(snap(y))           per tensor again, max |y|; bf16 RNE
// The snaps are those of `fxp_snap.cuh`, the same operations as the plain
// op's PyTorch on the card: bit-equal to `cordic_af_reference`. Without a
// precision there is no snap and no barrier.
//
// What bounds it: the MoE path's tensors are small (360k elements at
// decode, 1.4M per prefill chunk, 11k for the shared experts; 0.7-2.9 MB
// of bf16), about 100 f32 operations an element: under 2 us of the
// card's bytes or operations. The op used to take 23 device records (the
// kernel and 22 PyTorch ops of the two snaps), and the launches, not the
// work, set its time. Now the floor is one launch and two grid barriers.
//
// What the design does about it: one cooperative launch of 512-thread
// blocks, three phases meeting at two grid barriers. (a) Each thread loads
// its J elements (element j * threads-in-grid + t, so every load is
// coalesced) into registers; the block's max |x| goes to a slot. (b) Every
// block reduces the slots, snaps its elements, runs the AF and writes the
// block's max |y| to a second slot array. (c) Every block reduces those,
// snaps, casts and stores. x is read once and out written once; the AF
// runs once per element. J is the least of 1, 2, 4, 8, 16 for which the
// grid the card holds (occupancy of that J's kernel times the SMs) covers
// the tensor, and the grid is cut to the work (11k elements: 22 blocks).
// A wider grid spreads the AF, a narrower one shortens the barriers and
// each block's read of the slots; `tools/cordic_grid_sweep.py` times
// 256/512/1024 threads against J from 1/2/4/8 (PERF.md). A tensor past 16
// elements a thread of the resident grid takes the fallback (J = 0):
// grid-stride loops that read x from memory (L2) in each phase and run
// the AF twice (phases b and c), rather than stage n f32 results in a
// workspace. Without a precision the same fallback body runs once, as an
// ordinary launch.
#include "cordic.cuh"
#include "fxp_snap.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
cordic_af_kernel(const T* __restrict__ x, T* __restrict__ out,
                 unsigned* __restrict__ slots, long long n, int af, int lv_n,
                 int snap_on, SnapGrid g, CordicParams cp) {
  __shared__ unsigned red[32];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (J > 0) {
    float v[J];
    unsigned m = 0u;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const long long i = j * stride + t;
      v[j] = i < n ? load_f32(x + i) : 0.f;
      m = max(m, abs_bits(v[j]));
    }
    const float s_in = snap_scale(grid_max_bits(m, slots, red), g.qmax);
    m = 0u;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j * stride + t < n) {
        v[j] = apply_af(snap(v[j], s_in, g), af, cp, lv_n);
        m = max(m, abs_bits(v[j]));
      }
    }
    const float s_out =
        snap_scale(grid_max_bits(m, slots + gridDim.x, red), g.qmax);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const long long i = j * stride + t;
      if (i < n) store_f32(out + i, snap(v[j], s_out, g));
    }
  } else {
    float s_in = 0.f, s_out = 0.f;
    if (snap_on) {
      unsigned m = 0u;
      for (long long i = t; i < n; i += stride) {
        m = max(m, abs_bits(load_f32(x + i)));
      }
      s_in = snap_scale(grid_max_bits(m, slots, red), g.qmax);
      m = 0u;
      for (long long i = t; i < n; i += stride) {
        m = max(m, abs_bits(apply_af(snap(load_f32(x + i), s_in, g), af, cp,
                                     lv_n)));
      }
      s_out = snap_scale(grid_max_bits(m, slots + gridDim.x, red), g.qmax);
    }
    for (long long i = t; i < n; i += stride) {
      float v = load_f32(x + i);
      if (snap_on) v = snap(v, s_in, g);
      v = apply_af(v, af, cp, lv_n);
      if (snap_on) v = snap(v, s_out, g);
      store_f32(out + i, v);
    }
  }
}

template <typename T, int J>
int resident() {
  static const int r = resident_blocks(cordic_af_kernel<T, J>, kThreads);
  return r;
}

template <typename T, int J>
cudaError_t launch(const void* x, void* out, unsigned* slots, long long grid,
                   bool coop, long long n, int af, int lv_n, int snap_on,
                   SnapGrid g, const CordicParams& cp, cudaStream_t stream) {
  return launch_op(cordic_af_kernel<T, J>, grid, kThreads, coop, stream,
                   static_cast<const T*>(x), static_cast<T*>(out), slots, n,
                   af, lv_n, snap_on, g, cp);
}

// the least J from J up whose resident grid covers n; 0: none does
template <typename T, int J>
int held_per_thread(long long n) {
  if constexpr (J > 16) {
    return 0;
  } else {
    if (static_cast<long long>(resident<T, J>()) * kThreads * J >= n) {
      return J;
    }
    return held_per_thread<T, 2 * J>(n);
  }
}

template <typename T>
cudaError_t run(const void* x, void* out, unsigned* slots, int slot_cap,
                long long n, int af, int lv_n, int snap_on, SnapGrid g,
                const CordicParams& cp, cudaStream_t stream) {
  const int j = snap_on ? held_per_thread<T, 1>(n) : 0;
  const long long per_block = static_cast<long long>(kThreads) * (j ? j : 1);
  long long grid = (n + per_block - 1) / per_block;
  const long long cap = resident<T, 0>();
  if (j == 0 && grid > cap) grid = cap;
  if (snap_on && 2 * grid > slot_cap) return cudaErrorInvalidValue;
  const bool coop = snap_on != 0;
  switch (j) {
    case 1: return launch<T, 1>(x, out, slots, grid, coop, n, af, lv_n,
                                snap_on, g, cp, stream);
    case 2: return launch<T, 2>(x, out, slots, grid, coop, n, af, lv_n,
                                snap_on, g, cp, stream);
    case 4: return launch<T, 4>(x, out, slots, grid, coop, n, af, lv_n,
                                snap_on, g, cp, stream);
    case 8: return launch<T, 8>(x, out, slots, grid, coop, n, af, lv_n,
                                snap_on, g, cp, stream);
    case 16: return launch<T, 16>(x, out, slots, grid, coop, n, af, lv_n,
                                  snap_on, g, cp, stream);
    default: return launch<T, 0>(x, out, slots, grid, coop, n, af, lv_n,
                                 snap_on, g, cp, stream);
  }
}

}  // namespace

// dtype 0: f32, 1: bf16. snap_on: the per-tensor snaps onto [qmin, qmax]
// (slots: slot_cap words of workspace, two per block).
extern "C" int cordic_af_op(const void* x, void* out, unsigned* slots,
                            int slot_cap, long long n, int dtype, int af,
                            int lv_n, int snap_on, float qmin, float qmax,
                            const CordicParams* cp, void* stream) {
  if (n <= 0 || af <= AF_NONE || af > AF_EXP || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SnapGrid g{qmin, qmax};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? run<float>(x, out, slots, slot_cap, n, af, lv_n, snap_on,
                              g, *cp, s)
                 : run<__nv_bfloat16>(x, out, slots, slot_cap, n, af, lv_n,
                                      snap_on, g, *cp, s));
}
