// int8 x int8 -> int32 GEMM with four fused epilogues, and the fused
// quantize -> int8 GEMM -> dequantize kernel, for sm_90a.
//
// Replaces (TPU, Pallas):
//   qat_vit_tpu/ops/fused_serve.py::_plain_kernel       (K2a)  -> EPI_PLAIN
//   qat_vit_tpu/ops/long_block_kernel.py::_long_block_impl phase 1 with
//     int8_scores (K6's qkv GEMM + the q/k requantize)           -> EPI_PLAIN_Q8
//   qat_vit_tpu/ops/fused_serve.py::_gelu_q_kernel      (K2b)  -> EPI_GELU_Q
//   qat_vit_tpu/ops/fused_serve.py::_resid_ln_q_kernel  (K2c)  -> EPI_RESID_LN_Q
//   qat_vit_tpu/ops/pallas_gemm.py::_kernel             (K7)   -> qvt_quantize_gemm:
//     EPI_PLAIN with an f32 / bf16 A quantized in the A-tile prologue
// and the four GEMM stages of qat_vit_tpu/ops/block_kernel.py::_model_kernel
// (K4), which the port runs as a chain of these launches. The tile bodies
// (math, layout, design) are in gemm_tile.cuh, shared with megablock.cu.
//
// What bounds it on an H100. At the ViT-S serving shapes (M = B*197,
// K = 384..1536, N = 384..1536) each GEMM does 2*M*N*K int8 operations on
// M*K + K*N + M*N*(1..4) bytes: ~100-700 ops per byte, so the bound is the
// tensor cores (1,979 dense int8 TOP/s), not HBM (3.35 TB/s). K7 reads A as
// f32 (4 bytes per element), which moves its byte count up but not past that.
//
// This is a first, correct kernel: mma.sync on synchronously staged tiles;
// wgmma/TMA/pipelining are later work. PLAIN / PLAIN_Q8 / GELU_Q (and K7) run
// one block of 128 threads per (64-row, 64-column) output tile; RESID_LN_Q one block
// per 32 rows owning all N columns.

#include "gemm_tile.cuh"

namespace {

using namespace qvt::gemm;

template <int EPI, typename OutT, typename AT>
__global__ void __launch_bounds__(THREADS) gemm_tiled_kernel(GemmParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  tiled_body<EPI, OutT, AT, false>(p, smem, blockIdx.y * BM_TILED, blockIdx.x * BN,
                                   Group{static_cast<int>(threadIdx.x), 0});
}

template <typename OutT, typename ResT>
__global__ void __launch_bounds__(THREADS) gemm_resid_ln_kernel(GemmParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  resid_ln_body<OutT, ResT, false>(p, smem, blockIdx.x * BM_ROWS,
                                   Group{static_cast<int>(threadIdx.x), 0});
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           const GemmParams& p) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

GemmParams make_params(const void* a, const void* w, const void* colsum, const void* bias,
                       const void* wscale, int M, int N, int K, int ws_per_channel,
                       float ws0, float s_x, int z_s) {
  GemmParams p{};
  p.a = a;
  p.w = static_cast<const int8_t*>(w);
  p.colsum = static_cast<const int32_t*>(colsum);
  p.bias = static_cast<const float*>(bias);
  p.wscale = static_cast<const float*>(wscale);
  p.M = M;
  p.N = N;
  p.K = K;
  p.ws_per_channel = ws_per_channel;
  p.w_vec = (N % 4 == 0) ? 1 : 0;
  p.ws0 = ws0;
  p.s_x = s_x;
  p.z_s = z_s;
  return p;
}

}  // namespace

// Returns a cudaError_t (0 = launched). Pointers are device pointers; the
// kernel allocates nothing and does not synchronise.
extern "C" int qvt_int8_gemm(const void* a, const void* w, const void* colsum,
                             const void* bias, const void* wscale, const void* residual,
                             const void* gamma, const void* beta, void* y, void* q,
                             int M, int N, int K, int epilogue, int out_bf16,
                             int res_bf16, int ws_per_channel, int act, float ws0,
                             float s_x, int z_s, float inv_s, float zp, float qmax,
                             float eps, int q_n, void* stream) {
  GemmParams p = make_params(a, w, colsum, bias, wscale, M, N, K, ws_per_channel, ws0, s_x, z_s);
  p.residual = residual;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.y = y;
  p.q = static_cast<int8_t*>(q);
  p.act = act;
  p.inv_s = inv_s;
  p.zp = zp;
  p.qmax = qmax;
  p.eps = eps;
  p.q_n = q_n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;

  if (epilogue == EPI_RESID_LN_Q) {
    const dim3 grid((M + BM_ROWS - 1) / BM_ROWS);
    const size_t smem = resid_ln_smem_bytes(N);
    if (out_bf16 && res_bf16) return launch(gemm_resid_ln_kernel<bf16, bf16>, grid, smem, s, p);
    if (out_bf16) return launch(gemm_resid_ln_kernel<bf16, float>, grid, smem, s, p);
    if (res_bf16) return launch(gemm_resid_ln_kernel<float, bf16>, grid, smem, s, p);
    return launch(gemm_resid_ln_kernel<float, float>, grid, smem, s, p);
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM_TILED - 1) / BM_TILED);
  const size_t smem = tiled_smem_bytes();
  if (epilogue == EPI_GELU_Q)
    return launch(gemm_tiled_kernel<EPI_GELU_Q, float, int8_t>, grid, smem, s, p);
  if (epilogue == EPI_PLAIN_Q8) {  // bf16 y, as K6's qkv stage stores it
    if (!out_bf16 || q_n < 0 || q_n > N) return static_cast<int>(cudaErrorInvalidValue);
    return launch(gemm_tiled_kernel<EPI_PLAIN_Q8, bf16, int8_t>, grid, smem, s, p);
  }
  if (epilogue != EPI_PLAIN) return static_cast<int>(cudaErrorInvalidValue);
  if (out_bf16) return launch(gemm_tiled_kernel<EPI_PLAIN, bf16, int8_t>, grid, smem, s, p);
  return launch(gemm_tiled_kernel<EPI_PLAIN, float, int8_t>, grid, smem, s, p);
}

// K7: x [M, K] f32 (x_bf16 = 0) or bf16 is quantized in the A-tile prologue
// with (x_inv_s, x_zp, x_qmax), then the PLAIN epilogue writes y (f32 or
// bf16) with the input scale s_x and z_s = x_zp - 128.
extern "C" int qvt_quantize_gemm(const void* x, const void* w, const void* colsum,
                                 const void* bias, const void* wscale, void* y, int M, int N,
                                 int K, int x_bf16, int out_bf16, int ws_per_channel, float ws0,
                                 float s_x, int z_s, float x_inv_s, float x_zp, float x_qmax,
                                 void* stream) {
  GemmParams p = make_params(x, w, colsum, bias, wscale, M, N, K, ws_per_channel, ws0, s_x, z_s);
  p.y = y;
  p.a_inv_s = x_inv_s;
  p.a_zp = x_zp;
  p.a_qmax = x_qmax;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  const dim3 grid((N + BN - 1) / BN, (M + BM_TILED - 1) / BM_TILED);
  const size_t smem = tiled_smem_bytes();
  if (x_bf16 && out_bf16) return launch(gemm_tiled_kernel<EPI_PLAIN, bf16, bf16>, grid, smem, s, p);
  if (x_bf16) return launch(gemm_tiled_kernel<EPI_PLAIN, float, bf16>, grid, smem, s, p);
  if (out_bf16) return launch(gemm_tiled_kernel<EPI_PLAIN, bf16, float>, grid, smem, s, p);
  return launch(gemm_tiled_kernel<EPI_PLAIN, float, float>, grid, smem, s, p);
}
