// The CUDA-core attention tile body over the packed qkv. Its users: in
// csrc/attention_q.cu (one tile per block) the f32 kernel A and K8 in f32
// and bf16; in csrc/megablock.cu (a grid-stride loop over the tiles of the
// attention stage inside one cooperative launch) K9a / K9b's int8-out
// attention, which is therefore bit-identical to K3's plain version. The
// bf16 K3 and kernel A run on the tensor cores instead
// (csrc/attention_q_mma.cu).
//
// A tile is (64 queries, one head, one image) on 8 warps (256 threads). K
// and V of that head are staged whole in shared memory (N x hd elements
// each, fake-quantized on the way in when asked); the K rows are padded by
// one 32-bit word so that 32 lanes reading 32 different keys hit 32 banks.
// Each warp takes one query at a time: lanes split the keys for the scores
// (one f32 score row per warp in shared memory), warp-reduce max and sum,
// then split the head dims for p @ v. Layout in attention_smem_bytes
// (ops/flash_attention.py mirrors it).
//
// Numerics, as the TPU kernels. T is the qkv (and output) type: bf16 (K8,
// K9), or f32 (K8, and K1's forward for f32 models). With IN_FQ every q/k/v
// element is first fake-quantized (f32, round half to even, clip, back to T:
// a no-op rounding for f32). Without SCALE_AFTER (K1, K9's K3 stage) q is
// scaled by hd^-0.5 in the qkv type before the score dot; with SCALE_AFTER
// (K8) the f32 score is scaled after it. Keys >= n_valid get
// -1e30; f32 softmax; p is rounded to T before the value product; o
// accumulates in f32 and is either quantized with (inv_s, zp, qmax) or
// rounded to T, into the packed [B, N, H*hd] output at column h*hd.
//
// Every rounding is pinned so that the plain versions reproduce it bit for
// bit: both dots accumulate in f32 in index order (d, then j), exp and the
// softmax sum run in f64 before one rounding to f32; products go through
// mac<T> (common.cuh), an FMA for bf16 and __fmul_rn then __fadd_rn for
// f32, as ordered_dot's multiply-then-add.
//
// STREAM (the f32 kernel A alone, for heads whose K and V do not fit; K8 and
// K9 never take it): K, then V, pass through shared memory in tiles of
// KT keys, and each warp takes one query per round of the block's 64. The
// score row, the softmax and the order of every sum are the resident
// form's, so the output is the same bits.
#pragma once

#include "common.cuh"

namespace qvt {
namespace attn {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int Q_TILE = 64;

// shared-memory bytes of one tile (words per K row padded by one)
__host__ __device__ constexpr size_t smem_bytes(int N, int hd, int elem_bytes) {
  return sizeof(uint32_t) * ((size_t)N * (hd * elem_bytes / 4 + 1) +
                             (size_t)N * (hd * elem_bytes / 4)) +
         sizeof(float) * ((size_t)WARPS * N + (size_t)WARPS * hd);
}

constexpr int KT = 32;  // keys per tile of the STREAM form: one per lane

// shared-memory bytes of one STREAM tile: a K or V tile (rows padded by one
// word), one f32 score row of N and one q row per warp
__host__ __device__ constexpr size_t stream_smem_bytes(int N, int hd, int elem_bytes) {
  return sizeof(uint32_t) * (size_t)KT * (hd * elem_bytes / 4 + 1) +
         sizeof(float) * ((size_t)WARPS * N + (size_t)WARPS * hd);
}

// tile's STREAM form (the header's last paragraph)
template <typename T, bool QUANT_OUT, bool IN_FQ, bool SCALE_AFTER>
__device__ __forceinline__ void tile_streamed(const T* qkv, const float* qs, void* out, int N,
                                              int H, int hd, int n_valid, float scale,
                                              float inv_s, float zp, float qmax, float fq_min,
                                              float fq_max, uint8_t* smem, int q0, int h, int b) {
  constexpr int EPW = 4 / sizeof(T);
  const int D = H * hd, hw = hd / EPW, kst = hw + 1;
  uint32_t* Ts = reinterpret_cast<uint32_t*>(smem);             // [KT][kst] K or V
  float* Ps = reinterpret_cast<float*>(Ts + (size_t)KT * kst);  // [WARPS][N]
  float* Qs = Ps + (size_t)WARPS * N;                           // [WARPS][hd]
  const T* img = qkv + (size_t)b * N * 3 * D;
  float fs = 1.0f, fz = 0.0f;
  if constexpr (IN_FQ) {
    fs = qs[0];
    fz = qs[1];
  }
  // keys [k0, k0 + KT) of section sec (1: K, 2: V) into Ts, zero past N
  const auto stage = [&](int sec, int k0) {
    __syncthreads();  // every warp done with the previous tile
    for (int i = threadIdx.x; i < KT * hw; i += THREADS) {
      const int j = i / hw, w2 = i % hw;
      uint32_t w = 0u;
      if (k0 + j < N) {
        w = reinterpret_cast<const uint32_t*>(img + (size_t)(k0 + j) * 3 * D + sec * D +
                                              h * hd)[w2];
        if constexpr (IN_FQ) w = fake_quant_word<T>(w, fs, fz, fq_min, fq_max);
      }
      Ts[j * kst + w2] = w;
    }
    __syncthreads();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ps = Ps + (size_t)warp * N;
  float* qv = Qs + (size_t)warp * hd;
  const int q_end = min(q0 + Q_TILE, N);
  for (int r0 = q0; r0 < q_end; r0 += WARPS) {  // a round: one query per warp
    const int i = r0 + warp;
    const bool act = i < q_end;
    if (act) {
      const T* qrow = img + (size_t)i * 3 * D + h * hd;
      for (int d = lane; d < hd; d += 32) {
        float x = to_f32(qrow[d]);
        if constexpr (IN_FQ) x = round_to<T>(fake_quant(x, fs, fz, fq_min, fq_max));
        qv[d] = SCALE_AFTER ? x : round_to<T>(__fmul_rn(x, scale));
      }
    }
    __syncwarp();
    for (int k0 = 0; k0 < N; k0 += KT) {
      stage(1, k0);
      const int j = k0 + lane;
      if (act && j < N) {
        float s = -1e30f;
        if (j < n_valid) {
          s = 0.0f;
          const uint32_t* kr = Ts + lane * kst;
          for (int w2 = 0; w2 < hw; ++w2) {
            float kf[EPW];
            unpack_word<T>(kr[w2], kf);
#pragma unroll
            for (int e = 0; e < EPW; ++e) s = mac<T>(qv[EPW * w2 + e], kf[e], s);
          }
          if (SCALE_AFTER) s = __fmul_rn(s, scale);
        }
        ps[j] = s;
      }
    }
    if (act) {
      float mx = -1e30f;
      for (int j = lane; j < N; j += 32) mx = fmaxf(mx, ps[j]);
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
    }
    __syncwarp();

    float o[128 / 32];  // head dims lane, lane + 32, ..
#pragma unroll
    for (int u = 0; u < 128 / 32; ++u) o[u] = 0.0f;
    for (int k0 = 0; k0 < N; k0 += KT) {
      stage(2, k0);
      if (act) {
        const int k1 = min(k0 + KT, N);
#pragma unroll
        for (int u = 0; u < 128 / 32; ++u) {
          const int d = lane + 32 * u;
          if (d >= hd) continue;
          for (int j = k0; j < k1; ++j)
            o[u] = mac<T>(ps[j], to_f32(reinterpret_cast<const T*>(Ts + (j - k0) * kst)[d]),
                          o[u]);
        }
      }
    }
    if (act) {
#pragma unroll
      for (int u = 0; u < 128 / 32; ++u) {
        const int d = lane + 32 * u;
        if (d >= hd) continue;
        const size_t at = ((size_t)b * N + i) * D + h * hd + d;
        if (QUANT_OUT)
          static_cast<int8_t*>(out)[at] = quantize_shifted(o[u], inv_s, zp, qmax);
        else
          static_cast<T*>(out)[at] = from_f32<T>(o[u]);
      }
    }
    __syncwarp();
  }
}

template <typename T, bool QUANT_OUT, bool IN_FQ, bool SCALE_AFTER, bool STREAM = false>
__device__ __forceinline__ void tile(const T* qkv, const float* qs, void* out, int N, int H,
                                     int hd, int n_valid, float scale, float inv_s, float zp,
                                     float qmax, float fq_min, float fq_max, uint8_t* smem,
                                     int q0, int h, int b) {
  if constexpr (STREAM) {
    tile_streamed<T, QUANT_OUT, IN_FQ, SCALE_AFTER>(qkv, qs, out, N, H, hd, n_valid, scale,
                                                    inv_s, zp, qmax, fq_min, fq_max, smem, q0,
                                                    h, b);
    return;
  }
  constexpr int EPW = 4 / sizeof(T);  // elements per 32-bit word
  const int D = H * hd, hw = hd / EPW, kst = hw + 1;  // words per row; kst is odd
  uint32_t* Ks = reinterpret_cast<uint32_t*>(smem);  // [N][kst]
  uint32_t* Vs = Ks + (size_t)N * kst;               // [N][hw]
  float* Ps = reinterpret_cast<float*>(Vs + (size_t)N * hw);  // [WARPS][N]
  float* Qs = Ps + (size_t)WARPS * N;                          // [WARPS][hd]
  const T* img = qkv + (size_t)b * N * 3 * D;
  float fs = 1.0f, fz = 0.0f;
  if constexpr (IN_FQ) {
    fs = qs[0];
    fz = qs[1];
  }

  for (int i = threadIdx.x; i < N * hw; i += THREADS) {
    const int j = i / hw, w2 = i % hw;
    const T* row = img + (size_t)j * 3 * D + h * hd;
    uint32_t kw = reinterpret_cast<const uint32_t*>(row + D)[w2];
    uint32_t vw = reinterpret_cast<const uint32_t*>(row + 2 * D)[w2];
    if constexpr (IN_FQ) {
      kw = fake_quant_word<T>(kw, fs, fz, fq_min, fq_max);
      vw = fake_quant_word<T>(vw, fs, fz, fq_min, fq_max);
    }
    Ks[j * kst + w2] = kw;
    Vs[j * hw + w2] = vw;
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
      float x = to_f32(qrow[d]);
      if constexpr (IN_FQ) x = round_to<T>(fake_quant(x, fs, fz, fq_min, fq_max));
      qv[d] = SCALE_AFTER ? x : round_to<T>(__fmul_rn(x, scale));
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
        if (SCALE_AFTER) s = __fmul_rn(s, scale);
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
      const size_t at = ((size_t)b * N + i) * D + h * hd + d;
      if (QUANT_OUT)
        static_cast<int8_t*>(out)[at] = quantize_shifted(o, inv_s, zp, qmax);
      else
        static_cast<T*>(out)[at] = from_f32<T>(o);
    }
    __syncwarp();
  }
}

}  // namespace attn
}  // namespace qvt
