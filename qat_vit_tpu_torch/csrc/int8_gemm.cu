// The int8 GEMM with the RESID_LN_Q epilogue (K2c), for sm_90a. (PLAIN,
// PLAIN_Q8 and GELU_Q, K2a and K2b, and the fused quantize GEMM K7 are
// int8_gemm_wgmma.cu's.)
//
// Replaces (TPU, Pallas):
//   qat_vit_tpu/ops/fused_serve.py::_resid_ln_q_kernel  (K2c)  -> qvt_int8_gemm_resid_ln
// and the proj / fc2 stages of qat_vit_tpu/ops/block_kernel.py::_model_kernel
// (K4), which the port runs as a chain of launches.
//
// What bounds it on an H100. At the ViT-S serving shapes (M = B*197,
// K = 384..1536, N = 384) it does 2*M*N*K int8 operations on M*K + K*N +
// M*N*(2..4 + 1) bytes plus the residual: near the ridge of the tensor
// cores (1,979 dense int8 TOP/s) and HBM (3.35 TB/s).
//
// RESID_LN_Q (K2c) is pipelined. LayerNorm needs whole rows, so a block owns
// BM rows (64, 32 or 16, chosen by the wrapper: ops/fused_serve.
// resid_ln_rows) and ALL N columns. The block's tile is a __device__
// function in int8_gemm_resid_ln.cuh, which K9's proj and fc2 stages
// (megablock.cu) run as well. Here:
// - W comes pre-packed k-contiguous, [N, K] (serve/int8_vit.export_to_device
//   packs every int8 GEMM weight once, beside the JAX-layout [K, N] copy),
//   so a B tile is NC rows of 64 k-bytes, copied in 16-byte cp.async chunks
//   and read into mma fragments by ldmatrix, with no register transpose;
// - 8 warps, column passes of NC = 192 (N 384: two passes, 576: three), so
//   A is re-read N / 192 times (from L2), W once per block;
// - a ring of 3 cp.async stages of (A [BM x 64], B [192 x 64]) with one
//   barrier per k-step; rows of 80 bytes (conflict-free ldmatrix);
// - the pass's f32 y (dequant + residual) goes to the output and to a [BM x
//   (N + 4)] f32 block in shared memory; after the last pass each warp
//   takes rows and computes the LayerNorm statistics in f64
//   (warp_row_stats), as before, so y and q stay bit-identical to the plain
//   version (ops/fused_serve.int8_dense_resid_ln_q_plain).
// - the per-column constants (colsum, s_x w_scale, bias, LN gamma and beta)
//   are staged in shared memory once, and the epilogue issues its loads
//   before its stores: the int8 and bf16 outputs may alias any input as far
//   as the compiler knows, so a load after a store waits for it.
// Shared memory: 3 (BM + 192) 80 + BM (N + 4) 4 + 20 N bytes; every N the
// gate admits (RESID_LN_MAX_N) fits at BM 16.

#include "int8_gemm_resid_ln.cuh"

namespace {

using namespace qvt;
using namespace qvt::gemm;
using namespace qvt_resid_ln;

template <int BM, int WM, typename OutT, typename ResT>
__global__ void __launch_bounds__(RL_THREADS) gemm_resid_ln_kernel(GemmParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  resid_ln_tile<BM, WM, OutT, ResT>(p, smem, blockIdx.x * BM);
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const GemmParams& p,
           int threads) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int WM>
int launch_resid_ln(const GemmParams& p, int out_bf16, int res_bf16, cudaStream_t s) {
  typedef __nv_bfloat16 bf16;
  const dim3 grid((p.M + BM - 1) / BM);
  const size_t smem = rl_smem_bytes(BM, p.N);
  if (out_bf16 && res_bf16)
    return launch(gemm_resid_ln_kernel<BM, WM, bf16, bf16>, grid, smem, s, p, RL_THREADS);
  if (out_bf16) return launch(gemm_resid_ln_kernel<BM, WM, bf16, float>, grid, smem, s, p, RL_THREADS);
  if (res_bf16) return launch(gemm_resid_ln_kernel<BM, WM, float, bf16>, grid, smem, s, p, RL_THREADS);
  return launch(gemm_resid_ln_kernel<BM, WM, float, float>, grid, smem, s, p, RL_THREADS);
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
  p.ws0 = ws0;
  p.s_x = s_x;
  p.z_s = z_s;
  return p;
}

}  // namespace

// K2c: y = x_q @ W + residual (f32 or bf16 y), q = quantize(LN(y)). w_t is
// the weight packed k-contiguous, [N, K]; bm (64, 32 or 16) the rows of a
// block; K a multiple of 16 (k-steps past K zero-filled); N within the
// shared-memory plan at that bm.
extern "C" int qvt_int8_gemm_resid_ln(const void* a, const void* w_t, const void* colsum,
                                      const void* bias, const void* wscale, const void* residual,
                                      const void* gamma, const void* beta, void* y, void* q,
                                      int M, int N, int K, int bm, int out_bf16, int res_bf16,
                                      int ws_per_channel, float ws0, float s_x, int z_s,
                                      float inv_s, float zp, float qmax, float eps, void* stream) {
  if (K <= 0 || K % 16 || N <= 0 || M < 0 || rl_smem_bytes(bm, N) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmParams p = make_params(a, w_t, colsum, bias, wscale, M, N, K, ws_per_channel, ws0, s_x, z_s);
  p.residual = residual;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.y = y;
  p.q = static_cast<int8_t*>(q);
  p.inv_s = inv_s;
  p.zp = zp;
  p.qmax = qmax;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 64) return launch_resid_ln<64, 2>(p, out_bf16, res_bf16, s);
  if (bm == 32) return launch_resid_ln<32, 2>(p, out_bf16, res_bf16, s);
  if (bm == 16) return launch_resid_ln<16, 1>(p, out_bf16, res_bf16, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
