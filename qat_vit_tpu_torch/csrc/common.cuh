// Shared device helpers of the port's kernels (sm_90a).
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

// Fake-quant of one value, the arithmetic of quant/fake_quant.fake_quantize:
// q = rint(x / s + zp) in f32 (half to even), clipped to [qmin, qmax], then
// (q - zp) * s; every operation rounded on its own (no contraction).
__device__ __forceinline__ float fq_grid(float x, float s, float zp) {
  return rintf(__fadd_rn(__fdiv_rn(x, s), zp));
}

__device__ __forceinline__ float fake_quant(float x, float s, float zp, float qmin,
                                            float qmax) {
  const float q = fminf(fmaxf(fq_grid(x, s, zp), qmin), qmax);
  return __fmul_rn(__fsub_rn(q, zp), s);
}

// The straight-through estimator's mask: the gradient passes where the
// unclipped grid value lies in [qmin, qmax].
__device__ __forceinline__ bool ste_keep(float x, float s, float zp, float qmin, float qmax) {
  const float q = fq_grid(x, s, zp);
  return q >= qmin && q <= qmax;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Fake-quant both bf16 halves of a 32-bit word, back to bf16.
__device__ __forceinline__ uint32_t fake_quant_pair(uint32_t w, float s, float zp, float qmin,
                                                    float qmax) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  __nv_bfloat162 r = __floats2bfloat162_rn(fake_quant(f.x, s, zp, qmin, qmax),
                                           fake_quant(f.y, s, zp, qmin, qmax));
  return *reinterpret_cast<uint32_t*>(&r);
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

// Element-type helpers of the attention kernels, which take bf16 or f32
// operands (T). round_to<T> rounds an f32 value to T (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) { return round_bf16(v); }
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }

// acc + a * b in the kernels' pinned order: for bf16 operands the product is
// exact in f32, so an FMA rounds as multiply-then-add does; for f32 operands
// it is not, so multiply and add are rounded one after the other (never a
// contracted FMA), as the plain versions' multiply-then-add
template <typename T>
__device__ __forceinline__ float mac(float a, float b, float acc) {
  if constexpr (sizeof(T) == 2)
    return fmaf(a, b, acc);
  else
    return __fadd_rn(acc, __fmul_rn(a, b));
}

// the elements of one 32-bit word of T as f32
template <typename T>
__device__ __forceinline__ void unpack_word(uint32_t w, float (&f)[4 / sizeof(T)]) {
  if constexpr (sizeof(T) == 2) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
    f[0] = v.x;
    f[1] = v.y;
  } else {
    f[0] = __uint_as_float(w);
  }
}

// Fake-quant of the elements of one 32-bit word of T, back to T
template <typename T>
__device__ __forceinline__ uint32_t fake_quant_word(uint32_t w, float s, float zp, float qmin,
                                                   float qmax) {
  if constexpr (sizeof(T) == 2)
    return fake_quant_pair(w, s, zp, qmin, qmax);
  else
    return __float_as_uint(fake_quant(__uint_as_float(w), s, zp, qmin, qmax));
}

// 16-byte asynchronous copies from global to shared memory (cp.async)
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

// 4-byte asynchronous copy (cp.async.ca: the only form for fewer than 16 bytes)
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// the 8 bf16 values of a 16-byte chunk as f32
__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t x = words[i];
    const float2 v = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// the 16 / sizeof(T) values of T in a 16-byte chunk as f32
template <typename T>
__device__ __forceinline__ void unpack_chunk(const uint4& w, float (&f)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 2) {
    unpack8(w, f);
  } else {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
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
