// Long-sequence multi-head attention over the packed qkv, for sm_90a, in
// three forms sharing one body:
//
// - qvt_attention_long: output in f32 from an f32 qkv (K5's forward, f32
//   form; the bf16 form runs on the tensor cores, attention_long_mma.cu).
//   Replaces (TPU, Pallas): qat_vit_tpu/ops/long_attention.py::
//   _long_attention_kernel.
// - qvt_attention_long_q: output quantized to shifted int8 with the qkv
//   out_q grid (inv_s, zp, qmax): the attention stage of K6.
//   Replaces: phase 2 of qat_vit_tpu/ops/long_block_kernel.py::
//   _long_block_impl (run by _long_block_kernel and _long_model_kernel).
// - qvt_attention_long_q8: the same stage with int8 score dots, K6's
//   int8_scores option (the `i8` serving flag): q and k come as shifted int8
//   on the qkv out_q grid (int8_gemm's PLAIN_Q8 epilogue writes them), the
//   score is s_o^2 hd^-0.5 * (q8.k8 - z'(rowsum q8 + rowsum k8) + hd z'^2)
//   with z' = z_o - 128, summed exactly in int32 (__dp4a); softmax, p @ v
//   and the output are the bf16 form's. Replaces: _long_block_impl with
//   int8_scores=True.
//
// Numerics, as attention_q.cu and the TPU kernels: q is scaled by hd^-0.5 in
// the qkv type T; scores are f32 over the full key row, accumulated through
// mac<T> (bf16 products are exact in f32; f32 ones are multiplied and added
// with __fmul_rn / __fadd_rn); keys >= n_valid get -1e30; exact full-row
// softmax (the max, exp of the f32 difference in f64 rounded to f32, the sum
// in f64, p rounded to f32 and then to T); o accumulates in f32 in key order
// and is either rounded to T or quantized, into the packed [B, N, H*hd]
// output at column h*hd. Every rounding is pinned so that the plain versions
// (ops/long_attention.long_attention_qkv_plain, long_attention_q8_plain)
// reproduce it bit for bit: both dots accumulate in index order (d for the
// scores, key j for p @ v), and there is no online-softmax rescaling
// (FlashAttention's running max and sum would round differently; the TPU
// kernel softmaxes whole rows too).
//
// What bounds it on an H100. One head's K and V at OWLv2's 2,305 tokens and
// hd 64 are 295 KB each, more than the 227 KB of shared memory one block
// may use, so they cannot stay resident as in attention_q.cu: K and V
// stream through shared memory in tiles of KT keys. What stays is one f32
// score row per query (9.2 KB at N = 2,305); a block owns Q_TILE = 8 query
// rows (WARPS = 4 warps x ROWS = 2 rows), ~110 KB with two tile buffers,
// so two blocks fit an SM. Per (image, head) the work is 4*N*N*hd flops on
// 3*N*hd*2 bytes, compute-bound; this kernel runs both products on the
// CUDA cores (f32 FMA, 67 TFLOP/s peak; the int8-score form's q.k on
// __dp4a, whose int8 rate is a fraction of the tensor cores' 1,979 TOP/s)
// and every block re-reads its head's K and V (from L2). The exact softmax costs one f64 exp and one f64
// division per score. The forms here keep the kernel/plain identity; the
// bf16 forward left for the tensor cores (attention_long_mma.cu), held to a
// tolerance instead.
//
// Design, per block (q-tile of 8 rows, head, image):
// 1. stage the 8 q rows, scaled, as f32 in shared memory (int8 words for
//    the int8-score form);
// 2. stream 2*ceil(N/KT) tiles, the K tiles then the V tiles, through two
//    shared-memory buffers with cp.async (16-byte chunks; tile t+1 loads
//    while tile t is used). KT is 128 keys of bf16 and 64 of f32, so a tile
//    holds the same bytes in either type and the f32 form keeps two blocks
//    per SM. Rows are padded by one chunk so that 8 lanes reading the same
//    chunk of 8 different keys hit 8 different 16-byte bank groups. The
//    int8 K tiles of the int8-score form come as 4-byte copies into rows of
//    hd/4 + 1 words (an odd stride: 32 lanes on 32 banks);
// 3. K tiles: lane t of a warp takes keys t, t+32, ... of the tile and both
//    of the warp's rows (independent chains over d, 8 bf16 or 4 f32 of K per
//    16-byte load; or __dp4a over int8 words, with the key's row sum taken
//    in the same loop), and writes the f32 scores into the score rows;
// 4. before the first V tile, each warp softmaxes its two rows in place
//    (warp max, f64 warp sum);
// 5. V tiles: lanes split the head dims into 32-bit words (bf16 pairs or
//    f32) and walk the tile's keys in order, accumulating o for both rows
//    (p of 4 keys per load);
// 6. write o (in T, or quantized).

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 2;                 // query rows per warp
constexpr int Q_TILE = WARPS * ROWS;    // query rows per block
constexpr int MAX_HD = 128;

using qvt::cp_async16;
using qvt::cp_async4;
using qvt::cp_async_commit;
using qvt::cp_async_wait;

// keys per shared-memory tile: 128 of bf16, 64 of f32, so that a tile holds
// the same bytes in either type (csrc/attention_long_bwd.cu uses the same)
template <typename T>
constexpr int KEY_TILE = 256 / static_cast<int>(sizeof(T));

// T: the type of qkv (and of the float output). I8: the scores come from
// the int8 q / k rows of qk8 (the qkv out_q grid, [B, N, 2*H*hd]) as an
// int32 dot with the zero-point correction, times `scale` = s_o^2 hd^-0.5;
// otherwise from q (scaled by `scale` in T) and k of qkv. v always comes
// from qkv.
template <typename T, bool QUANT_OUT, bool I8>
__global__ void __launch_bounds__(WARPS * 32)
    long_attention_kernel(const T* qkv, const int8_t* qk8, void* out, int N, int H, int hd,
                          int n_valid, float scale, int zq8, float inv_s, float zp, float qmax) {
  using qvt::mac;
  using qvt::round_to;
  constexpr int KT = KEY_TILE<T>;
  constexpr int KPL = KT / 32;                    // keys per lane in a tile
  constexpr int EPC = 16 / sizeof(T);             // elements per 16-byte chunk
  constexpr int EPW = 4 / sizeof(T);              // elements per 32-bit word
  constexpr int WPL = MAX_HD / EPW / 32;          // words of a v row per lane
  extern __shared__ __align__(16) uint8_t smem[];
  const int q0 = blockIdx.x * Q_TILE, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, hw = hd / EPW;
  const int C = hd / EPC, CS = C + 1;  // 16-byte chunks per row; padded row stride
  const int hw8 = hd / 4, ks8 = hw8 + 1;  // int8 rows: words; odd padded stride
  const int ns = (N + 3) & ~3;       // score row stride (floats)
  const int ntiles = (N + KT - 1) / KT;
  float* S = reinterpret_cast<float*>(smem);  // [Q_TILE][ns] scores, then p
  float* Qs = S + (size_t)Q_TILE * ns;        // [Q_TILE][hd] scaled q, or int8 q words
  uint4* const buf0 = reinterpret_cast<uint4*>(Qs + Q_TILE * hd);  // [KT][CS] each
  uint4* const buf1 = buf0 + KT * CS;
  const T* img = qkv + (size_t)b * N * 3 * D;
  const int8_t* img8 = I8 ? qk8 + (size_t)b * N * 2 * D : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * ROWS;  // this warp's rows in the block

  // tile tt < ntiles: keys of K tile tt (int8 rows [KT][ks8] words with I8);
  // else keys of V tile tt - ntiles
  auto load_tile = [&](int tt, uint4* buf) {
    const int k0 = (tt % ntiles) * KT;
    const int nk = min(KT, N - k0);
    if (I8 && tt < ntiles) {
      uint32_t* w = reinterpret_cast<uint32_t*>(buf);
      for (int i = threadIdx.x; i < nk * hw8; i += blockDim.x) {
        const int j = i / hw8, c = i % hw8;
        cp_async4(w + j * ks8 + c, img8 + (size_t)(k0 + j) * 2 * D + D + h * hd + 4 * c);
      }
    } else {
      const int part = tt < ntiles ? 1 : 2;
      for (int i = threadIdx.x; i < nk * C; i += blockDim.x) {
        const int j = i / C, c = i % C;
        cp_async16(buf + j * CS + c,
                   img + (size_t)(k0 + j) * 3 * D + part * D + h * hd + EPC * c);
      }
    }
    cp_async_commit();
  };
  load_tile(0, buf0);

  if constexpr (I8) {
    int* Q8 = reinterpret_cast<int*>(Qs);  // [Q_TILE][hw8]
    for (int i = threadIdx.x; i < Q_TILE * hw8; i += blockDim.x) {
      const int r = i / hw8, c = i % hw8, qi = q0 + r;
      Q8[i] = qi < N ? *reinterpret_cast<const int*>(img8 + (size_t)qi * 2 * D + h * hd + 4 * c)
                     : 0;
    }
  } else {
    for (int i = threadIdx.x; i < Q_TILE * hd; i += blockDim.x) {
      const int r = i / hd, d = i % hd, qi = q0 + r;
      float x = 0.0f;
      if (qi < N)
        x = round_to<T>(__fmul_rn(qvt::to_f32(img[(size_t)qi * 3 * D + h * hd + d]), scale));
      Qs[i] = x;
    }
  }

  float o[ROWS][WPL][EPW];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int u = 0; u < WPL; ++u)
#pragma unroll
      for (int e = 0; e < EPW; ++e) o[r][u][e] = 0.0f;

  for (int tt = 0; tt < 2 * ntiles; ++tt) {
    const uint4* Tb = (tt & 1) ? buf1 : buf0;
    if (tt + 1 < 2 * ntiles) {
      load_tile(tt + 1, (tt & 1) ? buf0 : buf1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile tt (and the staged q) visible to every warp
    const int k0 = (tt % ntiles) * KT, nk = min(KT, N - k0);

    if (tt < ntiles) {
      // ---- scores of this K tile ----
      float sc[ROWS][KPL];
      if constexpr (I8) {
        // (q8 - z') . (k8 - z') = q8.k8 - z'(rowsum q8 + rowsum k8) + hd z'^2,
        // exact in int32 (dp4a: four int8 products per instruction)
        const int* Kw = reinterpret_cast<const int*>(Tb);
        const int* Q8 = reinterpret_cast<const int*>(Qs);
        int acc[ROWS][KPL], rk[KPL], rq[ROWS];
#pragma unroll
        for (int t = 0; t < KPL; ++t) rk[t] = 0;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          rq[r] = 0;
#pragma unroll
          for (int t = 0; t < KPL; ++t) acc[r][t] = 0;
        }
        for (int w = 0; w < hw8; ++w) {
          int kw[KPL];
#pragma unroll
          for (int t = 0; t < KPL; ++t) {
            kw[t] = Kw[min(lane + 32 * t, nk - 1) * ks8 + w];
            rk[t] = __dp4a(kw[t], 0x01010101, rk[t]);
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const int qw = Q8[(r0 + r) * hw8 + w];
            rq[r] = __dp4a(qw, 0x01010101, rq[r]);
#pragma unroll
            for (int t = 0; t < KPL; ++t) acc[r][t] = __dp4a(qw, kw[t], acc[r][t]);
          }
        }
        const int zz = hd * zq8 * zq8;
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int t = 0; t < KPL; ++t)
            sc[r][t] = __fmul_rn(static_cast<float>(acc[r][t] - zq8 * (rq[r] + rk[t]) + zz), scale);
      } else {
        // lane t takes keys t, t+32, ... of the tile and both of the warp's
        // rows: independent chains over d
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int t = 0; t < KPL; ++t) sc[r][t] = 0.0f;
        for (int c = 0; c < C; ++c) {
          float kf[KPL][EPC];
#pragma unroll
          for (int t = 0; t < KPL; ++t)
            qvt::unpack_chunk<T>(Tb[min(lane + 32 * t, nk - 1) * CS + c], kf[t]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float4* qr = reinterpret_cast<const float4*>(Qs + (r0 + r) * hd + EPC * c);
            float qf[EPC];
#pragma unroll
            for (int v = 0; v < EPC / 4; ++v) {
              const float4 q4 = qr[v];
              qf[4 * v] = q4.x;
              qf[4 * v + 1] = q4.y;
              qf[4 * v + 2] = q4.z;
              qf[4 * v + 3] = q4.w;
            }
#pragma unroll
            for (int t = 0; t < KPL; ++t)
#pragma unroll
              for (int e = 0; e < EPC; ++e) sc[r][t] = mac<T>(qf[e], kf[t][e], sc[r][t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        if (j < nk) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            S[(size_t)(r0 + r) * ns + k0 + j] = (k0 + j < n_valid) ? sc[r][t] : -1e30f;
        }
      }
    } else {
      if (tt == ntiles) {
        // ---- exact softmax of the warp's rows, in place (scores complete) ----
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float* s = S + (size_t)(r0 + r) * ns;
          float mx = -1e30f;  // the mask value: a lane with no keys cannot win the max
          for (int j = lane; j < N; j += 32) mx = fmaxf(mx, s[j]);
          mx = qvt::warp_max(mx);
          double sum = 0.0;
          for (int j = lane; j < N; j += 32) {
            const float e = static_cast<float>(exp(static_cast<double>(__fsub_rn(s[j], mx))));
            s[j] = e;
            sum += static_cast<double>(e);
          }
          sum = qvt::warp_sum(sum);
          for (int j = lane; j < N; j += 32)
            s[j] = round_to<T>(static_cast<float>(static_cast<double>(s[j]) / sum));
        }
        __syncwarp();
      }
      // ---- o += p @ v over this V tile, keys in order ----
      const uint32_t* Tw = reinterpret_cast<const uint32_t*>(Tb);
      auto step = [&](int j, const float (&p)[ROWS]) {
#pragma unroll
        for (int u = 0; u < WPL; ++u) {
          const int w2 = lane + 32 * u;
          if (w2 < hw) {
            float vf[EPW];
            qvt::unpack_word<T>(Tw[j * CS * 4 + w2], vf);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
#pragma unroll
              for (int e = 0; e < EPW; ++e) o[r][u][e] = mac<T>(p[r], vf[e], o[r][u][e]);
          }
        }
      };
      int j = 0;
      for (; j + 4 <= nk; j += 4) {  // p of 4 keys per (aligned, broadcast) load
        float4 p4[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          p4[r] = *reinterpret_cast<const float4*>(S + (size_t)(r0 + r) * ns + k0 + j);
        float p[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) p[r] = p4[r].x;
        step(j, p);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) p[r] = p4[r].y;
        step(j + 1, p);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) p[r] = p4[r].z;
        step(j + 2, p);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) p[r] = p4[r].w;
        step(j + 3, p);
      }
      for (; j < nk; ++j) {
        float p[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) p[r] = S[(size_t)(r0 + r) * ns + k0 + j];
        step(j, p);
      }
    }
    __syncthreads();  // every warp is done with tile tt before its buffer refills
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= N) continue;
#pragma unroll
    for (int u = 0; u < WPL; ++u) {
      const int w2 = lane + 32 * u;
      if (w2 >= hw) continue;
      const size_t at = ((size_t)b * N + qi) * D + h * hd + EPW * w2;
      if constexpr (QUANT_OUT) {
        int8_t* q = static_cast<int8_t*>(out) + at;
#pragma unroll
        for (int e = 0; e < EPW; ++e) q[e] = qvt::quantize_shifted(o[r][u][e], inv_s, zp, qmax);
      } else if constexpr (EPW == 2) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + at) =
            __floats2bfloat162_rn(o[r][u][0], o[r][u][1]);
      } else {
        static_cast<float*>(out)[at] = o[r][u][0];
      }
    }
  }
}

template <typename T, bool QUANT_OUT, bool I8>
int launch(const void* qkv, const void* qk8, void* out, int B, int N, int H, int hd, int n_valid,
           float scale, int zq8, float inv_s, float zp, float qmax, void* stream) {
  constexpr int KT = KEY_TILE<T>;
  const size_t smem = sizeof(float) * ((size_t)Q_TILE * ((N + 3) & ~3) + (size_t)Q_TILE * hd) +
                      sizeof(uint4) * 2 * (size_t)KT * (hd * sizeof(T) / 16 + 1);
  auto kernel = long_attention_kernel<T, QUANT_OUT, I8>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + Q_TILE - 1) / Q_TILE, H, B);
  kernel<<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<const int8_t*>(qk8), out, N, H, hd, n_valid, scale,
      zq8, inv_s, zp, qmax);
  return static_cast<int>(cudaGetLastError());
}

typedef __nv_bfloat16 bf16;

}  // namespace

// out f32 of the f32 qkv; scale is hd^-0.5 in f32
extern "C" int qvt_attention_long(const void* qkv, void* out, int B, int N, int H, int hd,
                                  int n_valid, float scale, void* stream) {
  return launch<float, false, false>(qkv, nullptr, out, B, N, H, hd, n_valid, scale, 0, 0.0f,
                                     0.0f, 0.0f, stream);
}

extern "C" int qvt_attention_long_q(const void* qkv, void* out, int B, int N, int H, int hd,
                                    int n_valid, float scale, float inv_s, float zp, float qmax,
                                    void* stream) {
  return launch<bf16, true, false>(qkv, nullptr, out, B, N, H, hd, n_valid, scale, 0, inv_s, zp,
                                   qmax, stream);
}

// the int8-score form: q and k from qk8 [B, N, 2*H*hd] (shifted int8 on the
// qkv out_q grid, zero point zq8 = z_o - 128), v from the bf16 qkv; sscale =
// s_o * s_o * hd^-0.5 in f32; out shifted int8 on (inv_s, zp, qmax)
extern "C" int qvt_attention_long_q8(const void* qk8, const void* qkv, void* out, int B, int N,
                                     int H, int hd, int n_valid, float sscale, int zq8,
                                     float inv_s, float zp, float qmax, void* stream) {
  return launch<bf16, true, true>(qkv, qk8, out, B, N, H, hd, n_valid, sscale, zq8, inv_s, zp,
                                  qmax, stream);
}
