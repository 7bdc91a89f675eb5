// Long-sequence multi-head attention over the packed f32 qkv, for sm_90a:
// K5's forward in f32 (qvt_attention_long). The bf16 form runs on the
// tensor cores (attention_long_mma.cu), and so do K6's two int8-output
// forms (attention_long_q_mma.cu).
//
// Replaces (TPU, Pallas): qat_vit_tpu/ops/long_attention.py::
// _long_attention_kernel, for an f32 qkv.
//
// Numerics, as attention_q.cu and the TPU kernel: q is scaled by hd^-0.5 in
// f32; scores are f32 over the full key row, each product and sum rounded
// on its own (__fmul_rn / __fadd_rn through mac<T>); keys >= n_valid get
// -1e30; exact full-row softmax (the max, exp of the f32 difference in f64
// rounded to f32, the sum in f64, p rounded to f32); o accumulates in f32
// in key order into the packed [B, N, H*hd] output at column h*hd. Every
// rounding is pinned so that the plain version
// (ops/long_attention.long_attention_qkv_plain) reproduces it bit for bit:
// both dots accumulate in index order (d for the scores, key j for p @ v),
// and there is no online-softmax rescaling (FlashAttention's running max
// and sum would round differently; the TPU kernel softmaxes whole rows too).
//
// What bounds it on an H100. One head's K and V at OWLv2's 2,305 tokens and
// hd 64 are 590 KB each in f32, more than the 227 KB of shared memory one
// block may use, so they cannot stay resident as in attention_q.cu: K and V
// stream through shared memory in tiles of KT keys. What stays is one f32
// score row per query (9.2 KB at N = 2,305); a block owns Q_TILE = 8 query
// rows (WARPS = 4 warps x ROWS = 2 rows), ~110 KB with two tile buffers,
// so two blocks fit an SM. Per (image, head) the work is 4*N*N*hd flops on
// 4*N*hd*4 bytes, compute-bound; both products run on the CUDA cores (f32
// FMA, 67 TFLOP/s peak) and every block re-reads its head's K and V (from
// L2). The exact softmax costs one f64 exp and one f64 division per score.
//
// Design, per block (q-tile of 8 rows, head, image):
// 1. stage the 8 q rows, scaled, as f32 in shared memory;
// 2. stream 2*ceil(N/KT) tiles, the K tiles then the V tiles, through two
//    shared-memory buffers with cp.async (16-byte chunks; tile t+1 loads
//    while tile t is used). KT is 64 keys of f32 (256 bytes of a key's
//    row per tile row, as csrc/attention_long_bwd.cu). Rows are padded by
//    one chunk so that 8 lanes reading the same chunk of 8 different keys
//    hit 8 different 16-byte bank groups;
// 3. K tiles: lane t of a warp takes keys t, t+32, ... of the tile and both
//    of the warp's rows (independent chains over d, 4 f32 of K per 16-byte
//    load), and writes the f32 scores into the score rows;
// 4. before the first V tile, each warp softmaxes its two rows in place
//    (warp max, f64 warp sum);
// 5. V tiles: lanes split the head dims into 32-bit words and walk the
//    tile's keys in order, accumulating o for both rows (p of 4 keys per
//    load);
// 6. write o.

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 2;                 // query rows per warp
constexpr int Q_TILE = WARPS * ROWS;    // query rows per block
constexpr int MAX_HD = 128;

using qvt::cp_async16;
using qvt::cp_async_commit;
using qvt::cp_async_wait;

// keys per shared-memory tile: 256 bytes of a key's row per tile row
// (csrc/attention_long_bwd.cu uses the same)
template <typename T>
constexpr int KEY_TILE = 256 / static_cast<int>(sizeof(T));

// T: the type of qkv and of the output (f32)
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    long_attention_kernel(const T* qkv, T* out, int N, int H, int hd, int n_valid, float scale) {
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
  const int ns = (N + 3) & ~3;       // score row stride (floats)
  const int ntiles = (N + KT - 1) / KT;
  float* S = reinterpret_cast<float*>(smem);  // [Q_TILE][ns] scores, then p
  float* Qs = S + (size_t)Q_TILE * ns;        // [Q_TILE][hd] scaled q
  uint4* const buf0 = reinterpret_cast<uint4*>(Qs + Q_TILE * hd);  // [KT][CS] each
  uint4* const buf1 = buf0 + KT * CS;
  const T* img = qkv + (size_t)b * N * 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * ROWS;  // this warp's rows in the block

  // tile tt < ntiles: keys of K tile tt; else keys of V tile tt - ntiles
  auto load_tile = [&](int tt, uint4* buf) {
    const int k0 = (tt % ntiles) * KT;
    const int nk = min(KT, N - k0);
    const int part = tt < ntiles ? 1 : 2;
    for (int i = threadIdx.x; i < nk * C; i += blockDim.x) {
      const int j = i / C, c = i % C;
      cp_async16(buf + j * CS + c, img + (size_t)(k0 + j) * 3 * D + part * D + h * hd + EPC * c);
    }
    cp_async_commit();
  };
  load_tile(0, buf0);

  for (int i = threadIdx.x; i < Q_TILE * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd, qi = q0 + r;
    float x = 0.0f;
    if (qi < N)
      x = round_to<T>(__fmul_rn(qvt::to_f32(img[(size_t)qi * 3 * D + h * hd + d]), scale));
    Qs[i] = x;
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
#pragma unroll
      for (int e = 0; e < EPW; ++e) out[at + e] = o[r][u][e];
    }
  }
}

int launch(const void* qkv, void* out, int B, int N, int H, int hd, int n_valid, float scale,
           void* stream) {
  typedef float T;
  constexpr int KT = KEY_TILE<T>;
  const size_t smem = sizeof(float) * ((size_t)Q_TILE * ((N + 3) & ~3) + (size_t)Q_TILE * hd) +
                      sizeof(uint4) * 2 * (size_t)KT * (hd * sizeof(T) / 16 + 1);
  auto kernel = long_attention_kernel<T>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + Q_TILE - 1) / Q_TILE, H, B);
  kernel<<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, H, hd, n_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out f32 of the f32 qkv; scale is hd^-0.5 in f32
extern "C" int qvt_attention_long(const void* qkv, void* out, int B, int N, int H, int hd,
                                  int n_valid, float scale, void* stream) {
  return launch(qkv, out, B, N, H, hd, n_valid, scale, stream);
}
