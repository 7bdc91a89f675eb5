// The CUDA-core attention tile body over the packed bf16 qkv, with the
// output quantized to shifted int8: K9a / K9b's attention stage. Its one
// user is csrc/megablock.cu (a grid-stride loop over the tiles of the
// attention stage inside one cooperative launch), whose attention is
// therefore bit-identical to K3's plain version. K3, kernel A and K8 run on
// the tensor cores (csrc/attention_q_mma.cu) in bf16, kernel A and K8 in f32
// on csrc/attention_f32.cu.
//
// A tile is (64 queries, one head, one image) on 8 warps (256 threads). K
// and V of that head are staged whole in shared memory (N x hd elements
// each); the K rows are padded by
// one 32-bit word so that 32 lanes reading 32 different keys hit 32 banks.
// Each warp takes one query at a time: lanes split the keys for the scores
// (one f32 score row per warp in shared memory), warp-reduce max and sum,
// then split the head dims for p @ v. Layout in attention_smem_bytes
// (ops/flash_attention.py mirrors it).
//
// Numerics, as the TPU kernel (K3's form of _fused_attention_kernel): q is
// scaled by hd^-0.5 in bf16 before the score dot; keys >= n_valid get
// -1e30; f32 softmax; p is rounded to bf16 before the value product; o
// accumulates in f32 and is quantized with (inv_s, zp, qmax) into the
// packed [B, N, H*hd] output at column h*hd.
//
// Every rounding is pinned so that the plain version reproduces it bit for
// bit: both dots accumulate in f32 in index order (d, then j), exp and the
// softmax sum run in f64 before one rounding to f32; products go through
// mac<bf16> (common.cuh), an FMA whose bf16 products are exact in f32, as
// ordered_dot's multiply-then-add.

#pragma once

#include "common.cuh"

namespace qvt {
namespace attn {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int Q_TILE = 64;

// shared-memory bytes of one tile (words per K row padded by one)
__host__ __device__ constexpr size_t smem_bytes(int N, int hd) {
  return sizeof(uint32_t) * ((size_t)N * (hd / 2 + 1) + (size_t)N * (hd / 2)) +
         sizeof(float) * ((size_t)WARPS * N + (size_t)WARPS * hd);
}

__device__ __forceinline__ void tile(const __nv_bfloat16* qkv, int8_t* out, int N, int H, int hd,
                                     int n_valid, float scale, float inv_s, float zp, float qmax,
                                     uint8_t* smem, int q0, int h, int b) {
  using T = __nv_bfloat16;
  constexpr int EPW = 2;  // elements per 32-bit word
  const int D = H * hd, hw = hd / EPW, kst = hw + 1;  // words per row; kst is odd
  uint32_t* Ks = reinterpret_cast<uint32_t*>(smem);  // [N][kst]
  uint32_t* Vs = Ks + (size_t)N * kst;               // [N][hw]
  float* Ps = reinterpret_cast<float*>(Vs + (size_t)N * hw);  // [WARPS][N]
  float* Qs = Ps + (size_t)WARPS * N;                          // [WARPS][hd]
  const T* img = qkv + (size_t)b * N * 3 * D;

  for (int i = threadIdx.x; i < N * hw; i += THREADS) {
    const int j = i / hw, w2 = i % hw;
    const T* row = img + (size_t)j * 3 * D + h * hd;
    Ks[j * kst + w2] = reinterpret_cast<const uint32_t*>(row + D)[w2];
    Vs[j * hw + w2] = reinterpret_cast<const uint32_t*>(row + 2 * D)[w2];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ps = Ps + (size_t)warp * N;
  float* qv = Qs + (size_t)warp * hd;
  const T* vb = reinterpret_cast<const T*>(Vs);
  const int q_end = min(q0 + Q_TILE, N);
  for (int i = q0 + warp; i < q_end; i += WARPS) {
    const T* qrow = img + (size_t)i * 3 * D + h * hd;
    for (int d = lane; d < hd; d += 32) {
      const float x = to_f32(qrow[d]);
      qv[d] = round_to<T>(__fmul_rn(x, scale));
    }
    __syncwarp();

    float mx = -1e30f;  // the mask value: a lane with no keys cannot win the max
    for (int j = lane; j < N; j += 32) {
      float s = -1e30f;
      if (j < n_valid) {
        s = 0.0f;
        const uint32_t* kr = Ks + j * kst;
        for (int w2 = 0; w2 < hw; ++w2) {
          float kf[EPW];
          unpack_word<T>(kr[w2], kf);
#pragma unroll
          for (int e = 0; e < EPW; ++e) s = mac<T>(qv[EPW * w2 + e], kf[e], s);
        }
      }
      ps[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    double sum = 0.0;
    for (int j = lane; j < N; j += 32) {
      const float e = static_cast<float>(exp(static_cast<double>(__fsub_rn(ps[j], mx))));
      ps[j] = e;
      sum += static_cast<double>(e);
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32)
      ps[j] = round_to<T>(static_cast<float>(static_cast<double>(ps[j]) / sum));
    __syncwarp();

    for (int d = lane; d < hd; d += 32) {
      float o = 0.0f;
      for (int j = 0; j < N; ++j) o = mac<T>(ps[j], to_f32(vb[(size_t)j * hd + d]), o);
      out[((size_t)b * N + i) * D + h * hd + d] = quantize_shifted(o, inv_s, zp, qmax);
    }
    __syncwarp();
  }
}

}  // namespace attn
}  // namespace qvt
