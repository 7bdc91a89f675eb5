// LayerNorm -> shifted int8, for sm_90a.
//
// Replaces (TPU, Pallas): qat_vit_tpu/ops/fused_serve.py::_ln_q_kernel (K2d).
// The port uses it for the entry LN of block 0 (the JAX megamodel path does
// that one in XLA) and wherever an LN output feeds an int8 GEMM with no GEMM
// before it.
//
// q = clamp(rint(LN(x) * inv_s + zp), 0, qmax) - 128, LN with f32
// statistics: mean, then mean((x - mean)^2), rsqrt(var + eps), gamma, beta.
//
// What bounds it on an H100: memory. It reads 2 (bf16) or 4 (f32) bytes and
// writes 1 byte per element, with ~10 flops per element, far below the
// card's ~300 flops/byte balance point; at ViT-S batch 256 ([50432, 384]
// bf16) the least time is ~58 MB / 3.35 TB/s = ~17 us.
//
// Simple design: one warp per row, 8 rows per 256-thread block, three
// passes over the row (sum, squared deviations, normalize + quantize). The
// row is re-read from global memory; the second and third reads hit L1/L2.
// Keeping the row in registers is the obvious next step.

#include "common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;

template <typename T>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
    ln_quantize_kernel(const T* x, const float* gamma, const float* beta, int8_t* q,
                       int M, int N, float inv_s, float zp, float qmax, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= M) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + (size_t)row * N;
  const auto load = [&](int c) { return qvt::to_f32(xr[c]); };
  const float2 st = qvt::warp_row_stats(load, N, eps);
  for (int c = lane; c < N; c += 32) {
    const float z = qvt::ln_affine(load(c), st, gamma[c], beta[c]);
    q[(size_t)row * N + c] = qvt::quantize_shifted(z, inv_s, zp, qmax);
  }
}

}  // namespace

extern "C" int qvt_ln_quantize(const void* x, const void* gamma, const void* beta, void* q,
                               int M, int N, int x_bf16, float inv_s, float zp, float qmax,
                               float eps, void* stream) {
  const dim3 grid((M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  int8_t* out = static_cast<int8_t*>(q);
  if (x_bf16) {
    ln_quantize_kernel<__nv_bfloat16><<<grid, ROWS_PER_BLOCK * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, b, out, M, N, inv_s, zp, qmax, eps);
  } else {
    ln_quantize_kernel<float><<<grid, ROWS_PER_BLOCK * 32, 0, s>>>(
        static_cast<const float*>(x), g, b, out, M, N, inv_s, zp, qmax, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
