// Shared device helpers of the int8 serving kernels (sm_90a).
//
// Activations travel as "shifted int8": the uint8 grid value minus 128.
// Every quantize here is clamp(rint(v * inv_s + zp), 0, qmax) - 128 with
// round half to even (rintf) and no FMA contraction, the arithmetic of the
// JAX package's `_q8` / `_quantize_shifted`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qvt {

__device__ __forceinline__ int8_t quantize_shifted(float v, float inv_s, float zp,
                                                   float qmax) {
  float q = rintf(__fadd_rn(__fmul_rn(v, inv_s), zp));
  q = fminf(fmaxf(q, 0.0f), qmax);
  return static_cast<int8_t>(static_cast<int>(q) - 128);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (mean, rsqrt(var + eps)) of one row held by a warp, as f32. The sums run
// in f64 and the two results are rounded to f32 once, so they do not depend
// on the summation order: the plain version (ops/fused_serve.layernorm_f32)
// gets the same f32 values, and the JAX kernels' f32 `_ln` stays within
// f32 rounding of them. mean first, then mean((x - mean)^2).
template <typename Load>
__device__ __forceinline__ float2 warp_row_stats(Load load, int n, float eps) {
  const int lane = threadIdx.x & 31;
  double s = 0.0;
  for (int c = lane; c < n; c += 32) s += static_cast<double>(load(c));
  const double mean = warp_sum(s) / n;
  double v = 0.0;
  for (int c = lane; c < n; c += 32) {
    const double d = static_cast<double>(load(c)) - mean;
    v += d * d;
  }
  const double var = warp_sum(v) / n;
  const double rstd = 1.0 / sqrt(var + static_cast<double>(eps));
  return make_float2(static_cast<float>(mean), static_cast<float>(rstd));
}

// (x - mean) * rstd * gamma + beta, in the JAX order, no contraction
__device__ __forceinline__ float ln_affine(float x, float2 st, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, st.x), st.y), g), b);
}

}  // namespace qvt
