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

// RN(a / n) for n >= 1 from inv_n = RN(1 / n), with no division: q =
// RN(a inv_n) is within an ulp of a / n, so r = a - q n is exact (one fma)
// and RN(q + r inv_n) = RN(a / n) (Markstein's theorem, binary64; the row
// sums here stay far from underflow). An infinite or NaN a gives q, as
// a / n does.
__device__ __forceinline__ double div_n(double a, double n, double inv_n) {
  const double q = a * inv_n;
  return isfinite(q) ? fma(fma(-q, n, a), inv_n, q) : q;
}

// The f32 rounding of RN(1 / RN(sqrt(v))), mostly with no division or square
// root: rsqrt(v) (within 1 ulp, CUDA's bound) lies within 3 ulps of that
// value. Where the f32 roundings of rsqrt(v) (1 -+ 2^-49), 7.5 ulps or more
// below and above it, agree, the value's f32 rounding is theirs (rounding is
// monotone); else, about one row in 2^25, the square root and division run.
__device__ __forceinline__ float rstd_f32(double v) {
  const double y = rsqrt(v);
  if (static_cast<float>(y * (1.0 - 0x1p-49)) == static_cast<float>(y * (1.0 + 0x1p-49)))
    return static_cast<float>(y);
  return static_cast<float>(1.0 / sqrt(v));
}

// (mean, 1 / sqrt(var + eps)) of one row held by a warp, as f32: mean
// first, then mean((x - mean)^2). The sums run in f64; mean and var are
// RN(sum / n) in f64, and the results are those of / n and 1 / sqrt in f64
// rounded to f32 once (div_n, rstd_f32: the same values by construction),
// as the plain version (ops/fused_serve.layernorm_f32) computes them. The
// summation order differs from the plain version's (and the squares may be
// fused into the adds), which moves the f64 sums in their last bits only:
// the f32 values agree unless an f64 result lies that close to an f32
// rounding boundary (held identical on every input tested, not by
// construction). The JAX kernels' f32 `_ln` stays within f32 rounding.
// row_stats_f64 finishes them from a lane's f64 sum of its values, s, and
// var_part(mean), the lane's f64 sum of (x - mean)^2; inv_n = RN(1 / n).
template <typename VarPart>
__device__ __forceinline__ float2 row_stats_f64(double s, int n, double inv_n, float eps,
                                                VarPart var_part) {
  const double dn = n;
  const double mean = div_n(warp_sum(s), dn, inv_n);
  const double var = div_n(warp_sum(var_part(mean)), dn, inv_n);
  return make_float2(static_cast<float>(mean), rstd_f32(var + static_cast<double>(eps)));
}

template <typename Load>
__device__ __forceinline__ float2 warp_row_stats(Load load, int n, float eps) {
  const int lane = threadIdx.x & 31;
  double s = 0.0;
  for (int c = lane; c < n; c += 32) s += static_cast<double>(load(c));
  return row_stats_f64(s, n, 1.0 / n, eps, [&](double mean) {
    double v = 0.0;
    for (int c = lane; c < n; c += 32) {
      const double d = static_cast<double>(load(c)) - mean;
      v += d * d;
    }
    return v;
  });
}

// (x - mean) * rstd * gamma + beta, in the JAX order, no contraction
__device__ __forceinline__ float ln_affine(float x, float2 st, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, st.x), st.y), g), b);
}

}  // namespace qvt
