// cordic_af — the Flex-PE CORDIC activation function, element by element,
// written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/cordic_af/cordic_af.py, cordic_af_pallas
// (body _af_block, repeat_iters=True). Computes out[i] = AF(x[i]) on f32
// with the range-extended HR-CORDIC exp and the LV-CORDIC divide of
// `cordic.cuh` (relu, sigmoid, tanh, silu, gelu, exp), the same device
// functions as the fused GEMM epilogue: bit-equal to the plain version.
//
// What bounds it: each element is read once and written once (8 bytes)
// and costs about 60 f32 operations (4 HR stages, 5 LV stages), some 7.5
// operations per byte against the card's ~20 f32 operations per byte of
// memory bandwidth, so it is bound by the bytes while the CORDIC stages
// stay in registers.
//
// What the design does about it: a grid-stride loop over 16-byte float4
// loads and stores (a scalar tail for a ragged end), a grid of at most 16
// blocks per SM, nothing staged in shared memory. The wrapper keeps the
// per-tensor FxP fake-quant of the input and output in PyTorch, as the
// reference keeps it in jnp outside its Pallas kernel.
#include <cuda_runtime.h>

#include <cstdint>

#include "cordic.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;
constexpr int kSms = 132;

__global__ void __launch_bounds__(kThreads)
cordic_af_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long n, int vec, int af, int lv_n, CordicParams cp) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      float4 v = __ldg(x4 + i);
      v.x = apply_af(v.x, af, cp, lv_n);
      v.y = apply_af(v.y, af, cp, lv_n);
      v.z = apply_af(v.z, af, cp, lv_n);
      v.w = apply_af(v.w, af, cp, lv_n);
      o4[i] = v;
    }
    done = 4 * n4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    out[i] = apply_af(__ldg(x + i), af, cp, lv_n);
  }
}

}  // namespace

extern "C" int cordic_af(const float* x, float* out, long long n, int vec,
                         int af, int lv_n, const CordicParams* cp,
                         void* stream) {
  if (n <= 0 || af <= AF_NONE || af > AF_EXP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kSms * kBlocksPerSm) blocks = kSms * kBlocksPerSm;
  cordic_af_kernel<<<static_cast<int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, out, n, vec, af,
                                                          lv_n, *cp);
  return static_cast<int>(cudaGetLastError());
}
