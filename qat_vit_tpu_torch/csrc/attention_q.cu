// Multi-head attention over the packed qkv, output quantized to shifted
// int8, for sm_90a.
//
// Replaces (TPU, Pallas): qat_vit_tpu/ops/flash_attention.py::
// _fused_attention_kernel with quantize=True (K3), and the attention stage
// of qat_vit_tpu/ops/block_kernel.py::_block_tile_body (K4).
//
// Numerics, as the TPU kernel: q is scaled by hd^-0.5 IN BF16; scores are
// f32 (bf16 x bf16 products are exact in f32); keys >= n_valid get -1e30;
// f32 softmax; p is rounded to bf16 before the value product; o accumulates
// in f32 and is quantized with (inv_s, zp, qmax) into the packed
// [B, N, H*hd] output at column h*hd. No transposes anywhere: q, k, v are
// read straight from the [B, N, 3*H*hd] qkv GEMM output.
//
// Every rounding is pinned so that the plain version
// (ops/flash_attention.fused_attention_qkv_plain) reproduces it bit for
// bit: the score and p @ v dots accumulate in f32 in index order (d, then
// j; the products are exact, so an FMA rounds as a multiply-then-add
// does), and exp and the softmax sum run in f64 before one rounding to f32.
// A ViT's int8 chain is chaotic: one +-1 flip in one activation moves
// ViT-S logits by ~0.5%, so the card's kernel-vs-plain check needs this.
//
// What bounds it on an H100. Per (image, head) it does 4*N*N*hd flops on
// 3*N*hd*2 bytes read and N*hd bytes written: ~170 flops/byte for ViT-S
// (N = 197, hd = 64), compute-bound on the tensor cores in principle. This
// first kernel runs both products on the CUDA cores (f32 FMA, 67 TFLOP/s
// peak) and is bound by them and by shared-memory reads.
//
// Simple design: one block per (q-tile of 64 queries, head, image), 8 warps.
// K and V of that head are staged whole in shared memory (N x hd bf16 each,
// ~50 KB at N = 197); the K rows are padded by one 32-bit word so that 32
// lanes reading 32 different keys hit 32 banks. Each warp takes one query
// at a time: lanes split the keys for the scores (one f32 score row per warp
// in shared memory), warp-reduce max and sum, then split the head dims for
// p @ v. The shared-memory budget bounds N (attention_smem_bytes in
// ops/flash_attention.py mirrors the layout below); mma.sync/wgmma for both
// products is the next step.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int Q_TILE = 64;

__global__ void __launch_bounds__(WARPS * 32)
    attention_q_kernel(const __nv_bfloat16* qkv, int8_t* out, int N, int H, int hd,
                       int n_valid, float scale, float inv_s, float zp, float qmax) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int q0 = blockIdx.x * Q_TILE, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, hw = hd / 2, kst = hw + 1;  // words per row; kst is odd
  uint32_t* Ks = reinterpret_cast<uint32_t*>(smem);  // [N][kst]
  uint32_t* Vs = Ks + (size_t)N * kst;               // [N][hw]
  float* Ps = reinterpret_cast<float*>(Vs + (size_t)N * hw);  // [WARPS][N]
  float* Qs = Ps + (size_t)WARPS * N;                          // [WARPS][hd]
  const __nv_bfloat16* img = qkv + (size_t)b * N * 3 * D;

  for (int i = threadIdx.x; i < N * hw; i += blockDim.x) {
    const int j = i / hw, w2 = i % hw;
    const __nv_bfloat16* row = img + (size_t)j * 3 * D + h * hd;
    Ks[j * kst + w2] = reinterpret_cast<const uint32_t*>(row + D)[w2];
    Vs[j * hw + w2] = reinterpret_cast<const uint32_t*>(row + 2 * D)[w2];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ps = Ps + (size_t)warp * N;
  float* qs = Qs + (size_t)warp * hd;
  const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(Vs);
  const int q_end = min(q0 + Q_TILE, N);
  for (int i = q0 + warp; i < q_end; i += WARPS) {
    const __nv_bfloat16* qrow = img + (size_t)i * 3 * D + h * hd;
    for (int d = lane; d < hd; d += 32)
      qs[d] = __bfloat162float(__float2bfloat16_rn(__bfloat162float(qrow[d]) * scale));
    __syncwarp();

    float mx = -1e30f;  // the mask value: a lane with no keys cannot win the max
    for (int j = lane; j < N; j += 32) {
      float s = -1e30f;
      if (j < n_valid) {
        s = 0.0f;
        const uint32_t* kr = Ks + j * kst;
        for (int w2 = 0; w2 < hw; ++w2) {
          uint32_t kw = kr[w2];
          const float2 kf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&kw));
          s = fmaf(qs[2 * w2], kf.x, s);
          s = fmaf(qs[2 * w2 + 1], kf.y, s);
        }
      }
      ps[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = qvt::warp_max(mx);
    double sum = 0.0;
    for (int j = lane; j < N; j += 32) {
      const float e = static_cast<float>(exp(static_cast<double>(__fsub_rn(ps[j], mx))));
      ps[j] = e;
      sum += static_cast<double>(e);
    }
    sum = qvt::warp_sum(sum);
    for (int j = lane; j < N; j += 32)
      ps[j] = __bfloat162float(
          __float2bfloat16_rn(static_cast<float>(static_cast<double>(ps[j]) / sum)));
    __syncwarp();

    for (int d = lane; d < hd; d += 32) {
      float o = 0.0f;
      for (int j = 0; j < N; ++j) o = fmaf(ps[j], __bfloat162float(vb[(size_t)j * hd + d]), o);
      out[((size_t)b * N + i) * D + h * hd + d] = qvt::quantize_shifted(o, inv_s, zp, qmax);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int qvt_attention_q(const void* qkv, void* out, int B, int N, int H, int hd,
                               int n_valid, float scale, float inv_s, float zp,
                               float qmax, void* stream) {
  const size_t smem =
      sizeof(uint32_t) * ((size_t)N * (hd / 2 + 1) + (size_t)N * (hd / 2)) +
      sizeof(float) * ((size_t)WARPS * N + (size_t)WARPS * hd);
  const cudaError_t e = cudaFuncSetAttribute(
      attention_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + Q_TILE - 1) / Q_TILE, H, B);
  attention_q_kernel<<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<int8_t*>(out), N, H, hd, n_valid,
      scale, inv_s, zp, qmax);
  return static_cast<int>(cudaGetLastError());
}
