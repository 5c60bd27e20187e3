// cordic_softmax — the Flex-PE CORDIC row softmax, written for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/cordic_softmax/cordic_softmax.py,
// cordic_softmax_pallas (body _kernel, repeat_iters=True). For each row of
// an f32 [M, N] matrix: m = max, e = hr_exp(x - m), s = sum(e), out =
// lv_div(e, s) (`cordic.cuh`; |e| <= s keeps every quotient inside the LV
// convergence range).
//
// The sum is taken in one fixed order, which the plain version
// (`cordic_softmax_plain`) repeats operation for operation: lane l of the
// row's warp adds e[l], e[l+32], e[l+64], ... in turn, starting from 0;
// then five xor-shuffle steps (offsets 16, 8, 4, 2, 1) each add the
// partner lane's value, which leaves the same total in every lane (f32
// addition commutes). A different order moves the sum by an ulp, and the
// LV divide turns that into a 2^-lv step of a probability.
//
// What bounds it: the MoE router's rows are 64 wide and there are 4-16 of
// them, a few KB in all: the launch, not the bytes or the ~100 f32
// operations per element, sets the time. The design is the simple one:
// one warp per row, eight rows per block, the row read from global memory
// (L1) in three passes (max; exp and sum; exp again and divide), so rows
// of any width run without shared memory. Recomputing hr_exp in the last
// pass gives the same bits as the second.
#include <cuda_runtime.h>

#include <cstdint>

#include "cordic.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
cordic_softmax_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int rows, int n, int lv_n, CordicParams cp) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                   // a whole warp leaves together
  const float* xr = x + static_cast<size_t>(row) * n;
  float* orow = out + static_cast<size_t>(row) * n;

  float m = __int_as_float(static_cast<int>(0xff800000u));  // -inf
  for (int j = lane; j < n; j += 32) m = fmaxf(m, xr[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  }

  float s = 0.f;
  for (int j = lane; j < n; j += 32) {
    s = __fadd_rn(s, hr_exp(__fsub_rn(xr[j], m), cp));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  }

  for (int j = lane; j < n; j += 32) {
    orow[j] = lv_div(hr_exp(__fsub_rn(xr[j], m), cp), s, lv_n);
  }
}

}  // namespace

extern "C" int cordic_softmax(const float* x, float* out, int rows, int n,
                              int lv_n, const CordicParams* cp,
                              void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarps - 1) / kWarps;
  cordic_softmax_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(x, out, rows, n,
                                                               lv_n, *cp);
  return static_cast<int>(cudaGetLastError());
}
