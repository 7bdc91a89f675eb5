// The int8 GEMMs' shared parameters and epilogue arithmetic: the kernels of
// csrc/int8_gemm_wgmma.cu (K2a, K2b, PLAIN_Q8, K7) and int8_gemm.cu (K2c),
// and K9's stages in megablock.cu, call dequant_value / dequant_scale and
// activation. One definition of the arithmetic is what makes the fused block
// bit-identical to the launch chain.
//
// Math. A is shifted int8 [M, K] (uint8 grid - 128), W is int8 (the kernels
// read it packed k-contiguous, [N, K]), colsum[n] = sum_k W[k, n]. With
// z_s = zp - 128:
//   y = float(acc - z_s * colsum[n]) * (s_x * w_scale[n]) + bias[n]
// PLAIN writes y (f32 or bf16). PLAIN_Q8 writes y and, for the first q_n
// columns, quantize(y) from the f32 y (not from the rounded output) into an
// [M, q_n] int8 array: the q and k of a qkv GEMM on the qkv out_q grid, for
// the int8 score dots of csrc/attention_long_q_mma.cu (K6's int8_scores, JAX
// ops/long_block_kernel.py `_q8(y[:, :2D], ...)`). GELU_Q writes
// quantize(act(y)), act = the tanh GELU of jax.nn.gelu(approximate=True) or
// quick-GELU y*sigmoid(1.702y). RESID_LN_Q adds the residual in f32, writes
// y, and writes quantize(LN(y)) with f32 statistics over the whole row. K7
// (int8_gemm_wgmma.cu) quantizes a float A (f32 or bf16) with the a_* grid
// first: clamp(rint(x * (1/s_x) + zp), 0, qmax) - 128.
#pragma once

#include "common.cuh"

namespace qvt {
namespace gemm {

enum Epilogue { EPI_PLAIN = 0, EPI_GELU_Q = 1, EPI_RESID_LN_Q = 2, EPI_PLAIN_Q8 = 3 };

struct GemmParams {
  const void* a;           // [M, K] shifted int8 (K7: f32 or bf16, quantized first)
  const int8_t* w;         // [N, K], packed k-contiguous
  const int32_t* colsum;   // [N]
  const float* bias;       // [N] or null
  const float* wscale;     // [N] when ws_per_channel, else unused
  const void* residual;    // [M, N] (RESID_LN_Q)
  const float* gamma;      // [N] (RESID_LN_Q)
  const float* beta;       // [N] (RESID_LN_Q)
  void* y;                 // [M, N] float output (PLAIN, RESID_LN_Q)
  int8_t* q;               // [M, N] int8 output (GELU_Q, RESID_LN_Q); [M, q_n] (PLAIN_Q8)
  int M, N, K;
  int ws_per_channel;
  int act;                 // 0 tanh-GELU, 1 quick-GELU
  float ws0;               // per-tensor weight scale
  float s_x;               // input activation scale
  int z_s;                 // input zero-point - 128
  float inv_s, zp, qmax;   // output quantize grid
  float eps;
  float a_inv_s, a_zp, a_qmax;  // input quantize grid of a float A (K7)
  int q_n;                 // PLAIN_Q8: the first q_n columns are also quantized
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// column n's dequant scale, s_x * w_scale[n]
__device__ __forceinline__ float dequant_scale(const GemmParams& p, int n) {
  return __fmul_rn(p.s_x, p.ws_per_channel ? p.wscale[n] : p.ws0);
}

// dequant's arithmetic on values (the kernels that stage a tile's colsum,
// scale and bias in shared memory call it directly)
__device__ __forceinline__ float dequant_value(int acc, int z_s, int colsum, float sw,
                                               bool has_bias, float bias) {
  const float y = __fmul_rn(static_cast<float>(acc - z_s * colsum), sw);
  return has_bias ? __fadd_rn(y, bias) : y;
}

__device__ __forceinline__ float activation(float y, int act) {
  if (act == 1) {  // quick-GELU, exact
    return __fmul_rn(y, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-1.702f * y))));
  }
  // jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))))
  const float k = 0.7978845608028654f;
  const float x3 = __fmul_rn(__fmul_rn(y, y), y);
  const float inner = __fmul_rn(k, __fadd_rn(y, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(y, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

}  // namespace gemm
}  // namespace qvt
