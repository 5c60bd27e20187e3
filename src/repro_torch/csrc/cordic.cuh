// CORDIC device functions shared by the Hopper kernels of this package.
//
// They reproduce, operation for operation, the float-structural CORDIC of
// `repro_torch.core.cordic` (and of the reference package's
// `extended_exp_float` / `lv_divide_float` / Pallas `_hr_exp` / `_lv_div`):
//
//   hr_exp(z)      range-extended HR exp: z = k ln2 + r, e^z = 2^k e^r
//   lv_div(n, d)   LV shift-add division, |n| <= |d|
//   exp2_int(k)    exact 2^k by building the f32 exponent field
//
// Numerics: every product and sum is written with an explicit
// round-to-nearest intrinsic, so no FMA contraction can move the range
// reduction `floor(z * (1/ln2) + 0.5)` and `r = z - k*ln2`; the shift-add
// stages multiply by +-2^-i and are exact. The constants (1/ln2, ln2,
// 1/gain, atanh(2^-i)) are Python doubles rounded once to f32 on the host
// (`core.cordic.device_constants`) and passed in `CordicParams`.
#pragma once

#include <cstdint>

#define CORDIC_MAX_STAGES 16

struct CordicParams {
  float inv_ln2;
  float ln2;
  float inv_gain;
  int hr_n;                          // HR stages (schedule length)
  int shifts[CORDIC_MAX_STAGES];     // HR iteration indices i (repeats kept)
  float atanh[CORDIC_MAX_STAGES];    // f32(atanh(2^-i)) per stage
};

// exact 2^-i for 0 <= i < 127
__device__ __forceinline__ float pow2_neg(int i) {
  return __int_as_float((127 - i) << 23);
}

__device__ __forceinline__ float exp2_int(float k) {
  float kc = k < -126.f ? -126.f : (k > 127.f ? 127.f : k);
  int ki = static_cast<int>(kc);
  return __int_as_float((ki + 127) << 23);
}

__device__ __forceinline__ float hr_exp(float z, const CordicParams& p) {
  z = z < -87.f ? -87.f : (z > 88.f ? 88.f : z);   // f32 exp range
  float k = floorf(__fadd_rn(__fmul_rn(z, p.inv_ln2), 0.5f));
  float r = __fsub_rn(z, __fmul_rn(k, p.ln2));
  float x = p.inv_gain;
  float y = 0.f;
  for (int s = 0; s < p.hr_n; ++s) {
    float pw = pow2_neg(p.shifts[s]);
    float d = r >= 0.f ? 1.f : -1.f;
    float xn = __fadd_rn(x, __fmul_rn(__fmul_rn(d, y), pw));
    float yn = __fadd_rn(y, __fmul_rn(__fmul_rn(d, x), pw));
    x = xn;
    y = yn;
    r = __fsub_rn(r, __fmul_rn(d, p.atanh[s]));
  }
  return __fmul_rn(__fadd_rn(x, y), exp2_int(k));
}

// d = -sign(x*y), ties (a zero product) to +1
__device__ __forceinline__ float lv_div(float num, float den, int n) {
  float x = den;
  float y = num;
  float q = 0.f;
  for (int i = 1; i <= n; ++i) {
    float pw = pow2_neg(i);
    float prod = __fmul_rn(x, y);
    float d = prod > 0.f ? -1.f : 1.f;
    y = __fadd_rn(y, __fmul_rn(__fmul_rn(d, x), pw));
    q = __fsub_rn(q, __fmul_rn(d, pw));
  }
  return q;
}

// sigmoid(x) = e^min(x,0) / (1 + e^-|x|)
__device__ __forceinline__ float cordic_sigmoid(float x, const CordicParams& p,
                                                int lv_n) {
  float e = hr_exp(-fabsf(x), p);
  float num = x >= 0.f ? 1.f : e;
  return lv_div(num, __fadd_rn(1.f, e), lv_n);
}

// The fused-epilogue activation set (Sel_AF minus softmax).
enum AfCode { AF_NONE = 0, AF_RELU, AF_SIGMOID, AF_TANH, AF_SILU, AF_GELU,
              AF_EXP };

__device__ __forceinline__ float apply_af(float v, int af,
                                          const CordicParams& p, int lv_n) {
  switch (af) {
    case AF_RELU:                  // torch.clamp_min on CUDA: NaN kept
      return v != v ? v : fmaxf(v, 0.f);
    case AF_SIGMOID:
      return cordic_sigmoid(v, p, lv_n);
    case AF_TANH: {
      float t = hr_exp(-2.f * fabsf(v), p);
      float mag = lv_div(__fsub_rn(1.f, t), __fadd_rn(1.f, t), lv_n);
      float sgn = v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
      return __fmul_rn(sgn, mag);
    }
    case AF_SILU:
      return __fmul_rn(v, cordic_sigmoid(v, p, lv_n));
    case AF_GELU:
      return __fmul_rn(v, cordic_sigmoid(__fmul_rn(1.702f, v), p, lv_n));
    case AF_EXP:
      return hr_exp(v, p);
    default:
      return v;
  }
}
