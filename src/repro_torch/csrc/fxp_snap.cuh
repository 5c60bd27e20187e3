// The per-tensor FxP snap and the grid-wide phases shared by the CORDIC op
// kernels (`cordic_af.cu`, `cordic_softmax.cu`), for Hopper (sm_90a).
//
// The snap repeats, operation for operation, what the port's plain op
// (`core.fxp.fake_quant`, per tensor) computes in PyTorch on a CUDA tensor:
//
//   amax  = max |x|                      NaN propagates (torch.amax)
//   amax  = clamp_min(amax, f32(1e-12))  NaN kept (torch.clamp_min)
//   scale = amax * f32(1 / qmax)         PyTorch's CUDA divide by a host
//                                        scalar multiplies by its f32
//                                        reciprocal (pinned on the card by
//                                        tests/test_torch_cuda.py)
//   c     = rint(x / scale)              IEEE divide by the device scalar,
//                                        round half to even (torch.round)
//   c     = clamp(c, qmin, qmax)         NaN kept (torch.clamp)
//   x'    = float(int(c)) * scale        the integer codes back to f32:
//                                        -0.0 becomes +0.0
//
// |x| is reduced as the bits of x with the sign cleared, as unsigned
// integers: for values >= 0 (and NaN above +inf) that order is the float
// order, max is exact in any order, and a NaN wins as torch.amax lets it.
//
// The grid-wide max (`grid_max_bits`): each block writes its max to slot
// blockIdx.x of a workspace, the grid meets at a barrier, then every block
// reduces all the slots itself. No atomics, nothing zeroed beforehand, no
// state kept between launches: a replay or a second stream sees nothing
// stale. The barrier is cooperative_groups' grid sync, so the launch must
// be cooperative (`launch_op`): a grid the card cannot hold at once is
// refused at launch, and the wrapper raises. A grid of one block keeps its
// maxima in shared memory and meets at __syncthreads.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// |v| as ordered unsigned bits (NaN above every number)
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// torch.amax's max: a NaN on either side wins
__device__ __forceinline__ float max_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
}

struct SnapGrid {
  float qmin;
  float qmax;
};

// the per-tensor scale from max |x| (as bits)
__device__ __forceinline__ float snap_scale(unsigned amax_bits, float qmax) {
  float amax = __uint_as_float(amax_bits);
  amax = is_nan(amax) ? amax : fmaxf(amax, 1e-12f);
  return __fmul_rn(amax, __fdiv_rn(1.f, qmax));
}

__device__ __forceinline__ float snap(float v, float scale, SnapGrid g) {
  float c = rintf(__fdiv_rn(v, scale));
  c = is_nan(c) ? c : fminf(fmaxf(c, g.qmin), g.qmax);
  return __fmul_rn(__int2float_rn(__float2int_rz(c)), scale);
}

// max of `v` over the block, in every thread; `red` is __shared__ [32]
__device__ __forceinline__ unsigned block_max_bits(unsigned v,
                                                   unsigned* red) {
  v = __reduce_max_sync(0xffffffffu, v);
  __syncthreads();                       // `red` free from its last use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const unsigned lane = threadIdx.x & 31;
  v = lane < (blockDim.x >> 5) ? red[lane] : 0u;
  return __reduce_max_sync(0xffffffffu, v);
}

// max of `v` over the grid, in every thread of every block; `slots` holds
// gridDim.x words of this phase (read past L1: other SMs wrote them). A
// grid of one block needs neither the slots nor the barrier.
__device__ __forceinline__ unsigned grid_max_bits(unsigned v,
                                                  unsigned* slots,
                                                  unsigned* red) {
  v = block_max_bits(v, red);
  if (gridDim.x == 1) return v;
  if (threadIdx.x == 0) slots[blockIdx.x] = v;
  cooperative_groups::this_grid().sync();
  unsigned m = 0u;
#pragma unroll 4
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
    m = max(m, __ldcg(slots + b));
  }
  return block_max_bits(m, red);
}

// the blocks of `kernel` the card holds at once (one card per process)
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return sms * per_sm;
}

// one launch of `kernel`, cooperative when its phases meet at a barrier
template <typename... Params, typename... Args>
cudaError_t launch_op(void (*kernel)(Params...), long long grid, int threads,
                      bool cooperative, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cooperative ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
