// Long-sequence multi-head attention over the packed qkv, for sm_90a, in two
// forms sharing one body:
//
// - qvt_attention_long: output in bf16 (K5's forward).
//   Replaces (TPU, Pallas): qat_vit_tpu/ops/long_attention.py::
//   _long_attention_kernel.
// - qvt_attention_long_q: output quantized to shifted int8 with the qkv
//   out_q grid (inv_s, zp, qmax): the attention stage of K6.
//   Replaces: phase 2 of qat_vit_tpu/ops/long_block_kernel.py::
//   _long_block_impl (run by _long_block_kernel and _long_model_kernel).
//
// Numerics, as attention_q.cu and the TPU kernels: q is scaled by hd^-0.5 IN
// BF16; scores are f32 (bf16 x bf16 products are exact in f32) over the
// full key row; keys >= n_valid get -1e30; exact full-row softmax (the max,
// exp of the f32 difference in f64 rounded to f32, the sum in f64, p rounded
// to f32 and then to bf16); o accumulates in f32 in key order and is either
// rounded to bf16 or quantized, into the packed [B, N, H*hd] output at
// column h*hd. Every rounding is pinned so that the plain version
// (ops/long_attention.long_attention_qkv_plain) reproduces it bit for bit:
// both dots accumulate in index order (d for the scores, key j for p @ v),
// and there is no online-softmax rescaling (FlashAttention's running max
// and sum would round differently; the TPU kernel softmaxes whole rows too).
//
// What bounds it on an H100. One head's K and V at OWLv2's 2,305 tokens and
// hd 64 are 295 KB each, more than the 227 KB of shared memory one block
// may use, so they cannot stay resident as in attention_q.cu: K and V
// stream through shared memory in tiles of KT keys. What stays is one f32
// score row per query (9.2 KB at N = 2,305); a block owns Q_TILE = 8 query
// rows (WARPS = 4 warps x ROWS = 2 rows), ~110 KB with two tile buffers,
// so two blocks fit an SM. Per (image, head) the work is 4*N*N*hd flops on
// 3*N*hd*2 bytes, compute-bound; this kernel runs both products on the
// CUDA cores (f32 FMA, 67 TFLOP/s peak) and every block re-reads its head's
// K and V (from L2). The exact softmax costs one f64 exp and one f64
// division per score. Tensor cores (mma/wgmma) are the next step and must
// keep the kernel/plain identity.
//
// Design, per block (q-tile of 8 rows, head, image):
// 1. stage the 8 q rows, scaled, as f32 in shared memory;
// 2. stream 2*ceil(N/KT) tiles, the K tiles then the V tiles, through two
//    shared-memory buffers with cp.async (16-byte chunks; tile t+1 loads
//    while tile t is used). Rows are padded by one chunk so that 8 lanes
//    reading the same chunk of 8 different keys hit 8 different 16-byte
//    bank groups;
// 3. K tiles: lane t of a warp takes keys t, t+32, t+64, t+96 of the tile
//    and both of the warp's rows (8 independent FMA chains over d, 8 bf16
//    of K per 16-byte load), and writes the f32 scores into the score rows;
// 4. before the first V tile, each warp softmaxes its two rows in place
//    (warp max, f64 warp sum);
// 5. V tiles: lanes split the head dims into bf16 pairs and walk the tile's
//    keys in order, accumulating o for both rows (p of 4 keys per load);
// 6. write o (bf16, or quantized).

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 2;                 // query rows per warp
constexpr int Q_TILE = WARPS * ROWS;    // query rows per block
constexpr int KT = 128;                 // keys per shared-memory tile
constexpr int KPL = KT / 32;            // keys per lane in a tile
constexpr int MAX_WORDS_PER_LANE = 2;   // hd <= 128: hd/2 <= 64 bf16 pairs

using qvt::cp_async16;
using qvt::cp_async_commit;
using qvt::cp_async_wait;
using qvt::unpack8;

template <bool QUANT_OUT>
__global__ void __launch_bounds__(WARPS * 32)
    long_attention_kernel(const __nv_bfloat16* qkv, void* out, int N, int H, int hd,
                          int n_valid, float scale, float inv_s, float zp, float qmax) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int q0 = blockIdx.x * Q_TILE, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, hw = hd / 2;
  const int C = hd / 8, CS = C + 1;  // 16-byte chunks per row; padded row stride
  const int ns = (N + 3) & ~3;       // score row stride (floats)
  const int ntiles = (N + KT - 1) / KT;
  float* S = reinterpret_cast<float*>(smem);  // [Q_TILE][ns] scores, then p
  float* Qs = S + (size_t)Q_TILE * ns;        // [Q_TILE][hd] scaled q
  uint4* const buf0 = reinterpret_cast<uint4*>(Qs + Q_TILE * hd);  // [KT][CS] each
  uint4* const buf1 = buf0 + KT * CS;
  const __nv_bfloat16* img = qkv + (size_t)b * N * 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * ROWS;  // this warp's rows in the block

  // tile tt < ntiles: keys of K tile tt; else keys of V tile tt - ntiles
  auto load_tile = [&](int tt, uint4* buf) {
    const int k0 = (tt % ntiles) * KT, part = tt < ntiles ? 1 : 2;
    const int nk = min(KT, N - k0);
    for (int i = threadIdx.x; i < nk * C; i += blockDim.x) {
      const int j = i / C, c = i % C;
      cp_async16(buf + j * CS + c, img + (size_t)(k0 + j) * 3 * D + part * D + h * hd + 8 * c);
    }
    cp_async_commit();
  };
  load_tile(0, buf0);

  for (int i = threadIdx.x; i < Q_TILE * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd, qi = q0 + r;
    float x = 0.0f;
    if (qi < N) x = qvt::round_bf16(__bfloat162float(img[(size_t)qi * 3 * D + h * hd + d]) * scale);
    Qs[i] = x;
  }

  float2 o[ROWS][MAX_WORDS_PER_LANE];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int u = 0; u < MAX_WORDS_PER_LANE; ++u) o[r][u] = make_float2(0.0f, 0.0f);

  for (int tt = 0; tt < 2 * ntiles; ++tt) {
    const uint4* T = (tt & 1) ? buf1 : buf0;
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
      float acc[ROWS][KPL];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int t = 0; t < KPL; ++t) acc[r][t] = 0.0f;
      for (int c = 0; c < C; ++c) {
        float kf[KPL][8];
#pragma unroll
        for (int t = 0; t < KPL; ++t) unpack8(T[min(lane + 32 * t, nk - 1) * CS + c], kf[t]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4* qr = reinterpret_cast<const float4*>(Qs + (r0 + r) * hd + 8 * c);
          const float4 qa = qr[0], qb = qr[1];
          const float qf[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
          for (int t = 0; t < KPL; ++t)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r][t] = fmaf(qf[e], kf[t][e], acc[r][t]);
        }
      }
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        if (j < nk) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            S[(size_t)(r0 + r) * ns + k0 + j] = (k0 + j < n_valid) ? acc[r][t] : -1e30f;
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
            s[j] = qvt::round_bf16(static_cast<float>(static_cast<double>(s[j]) / sum));
        }
        __syncwarp();
      }
      // ---- o += p @ v over this V tile, keys in order ----
      const uint32_t* Tw = reinterpret_cast<const uint32_t*>(T);
      auto step = [&](int j, const float (&p)[ROWS]) {
#pragma unroll
        for (int u = 0; u < MAX_WORDS_PER_LANE; ++u) {
          const int w2 = lane + 32 * u;
          if (w2 < hw) {
            uint32_t vw = Tw[j * CS * 4 + w2];
            const float2 vf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&vw));
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              o[r][u].x = fmaf(p[r], vf.x, o[r][u].x);
              o[r][u].y = fmaf(p[r], vf.y, o[r][u].y);
            }
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
    for (int u = 0; u < MAX_WORDS_PER_LANE; ++u) {
      const int w2 = lane + 32 * u;
      if (w2 >= hw) continue;
      const size_t at = ((size_t)b * N + qi) * D + h * hd + 2 * w2;
      if (QUANT_OUT) {
        int8_t* q = static_cast<int8_t*>(out) + at;
        q[0] = qvt::quantize_shifted(o[r][u].x, inv_s, zp, qmax);
        q[1] = qvt::quantize_shifted(o[r][u].y, inv_s, zp, qmax);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + at) =
            __floats2bfloat162_rn(o[r][u].x, o[r][u].y);
      }
    }
  }
}

template <bool QUANT_OUT>
int launch(const void* qkv, void* out, int B, int N, int H, int hd, int n_valid, float scale,
           float inv_s, float zp, float qmax, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)Q_TILE * ((N + 3) & ~3) + (size_t)Q_TILE * hd) +
                      sizeof(uint4) * 2 * (size_t)KT * (hd / 8 + 1);
  const cudaError_t e = cudaFuncSetAttribute(long_attention_kernel<QUANT_OUT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + Q_TILE - 1) / Q_TILE, H, B);
  long_attention_kernel<QUANT_OUT><<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), out, N, H, hd, n_valid, scale, inv_s, zp, qmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qvt_attention_long(const void* qkv, void* out, int B, int N, int H, int hd,
                                  int n_valid, float scale, void* stream) {
  return launch<false>(qkv, out, B, N, H, hd, n_valid, scale, 0.0f, 0.0f, 0.0f, stream);
}

extern "C" int qvt_attention_long_q(const void* qkv, void* out, int B, int N, int H, int hd,
                                    int n_valid, float scale, float inv_s, float zp, float qmax,
                                    void* stream) {
  return launch<true>(qkv, out, B, N, H, hd, n_valid, scale, inv_s, zp, qmax, stream);
}
