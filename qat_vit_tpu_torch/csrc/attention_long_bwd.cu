// Backward of the long-sequence attention over the packed qkv, for sm_90a
// (K5b, the VJP of qvt_attention_long).
//
// Replaces (TPU, Pallas): qat_vit_tpu/ops/long_attention.py::
// _long_attention_bwd_kernel (launched by _long_attention_bwd_call).
//
// Math, per (image, head), as the TPU kernel, for a bf16 or an f32 qkv (T):
//   s  = (T(q * scale)) k^T        the q scaling IN T before the f32 dot,
//                                  as the forward; keys >= n_valid at -1e30;
//   p  = softmax(s) in f32;  dp = do v^T in f32;
//   ds = T(p * (dp - rowsum(dp * p)));   p16 = T(p)   (no-ops for f32);
//   dq = (ds k) * scale,  dk = (ds^T q) * scale (q unscaled),  dv = p16^T do,
// each summed in f32 and rounded to T once, into the packed dqkv
// [B, N, 3*H*hd]. Query rows >= n_valid are padding: their cotangent is taken
// as zero (their dq rows are zero and they add nothing to dk and dv), as the
// TPU wrapper pads do with zeros.
//
// Every rounding is pinned so that the plain version
// (ops/long_attention.long_attention_bwd_plain) replays it bit for bit: all
// dots accumulate in f32 in index order (d for s and dp, keys for dq,
// queries for dk and dv) through mac<T> (an FMA of exact bf16 products, or
// __fmul_rn then __fadd_rn for f32); exp runs in f64
// and is rounded to f32; the softmax sum and rowsum(dp * p) (of f32
// products) accumulate in f64 and are rounded once; p = f32(e / sum) with
// the f64 sum.
//
// What bounds it on an H100. Per (image, head) the VJP is 10*N*N*hd flops
// (s, dp, dq, dk, dv) on 4*N*hd*2 bytes read and 3*N*hd*2 written: ~2,000
// flops per byte at OWLv2's 2,305 tokens, compute-bound. This first kernel
// recomputes s and dp once more (14*N*N*hd flops) and runs every product on
// the CUDA cores (f32 FMA, 67 TFLOP/s peak). It now runs only the f32 form,
// bit-identical to its plain version; the bf16 form runs on the tensor cores
// (attention_long_bwd_mma.cu), held to a tolerance instead.
//
// Design. One head's q, k, v and do at 2,305 tokens and hd 64 are ~1.2 MB,
// over the 227 KB a block may use, so kernel B's plan (a whole (image, head)
// resident in one block) does not carry over. The TPU kernel carries dk and
// dv across a sequential grid dimension; blocks here run in no order, and
// atomics would sum in an order that changes from run to run. So two passes,
// each deterministic:
// 1. rows: one block per (WARPS query rows, head, image), one row per warp.
//    K, V, then K again stream through two shared-memory tile buffers
//    (cp.async, 16-byte chunks, 128 keys of bf16 or 64 of f32 per tile, as
//    qvt_attention_long). The row's f32 scores
//    and dp stay in shared memory (2 x 9.2 KB at N = 2,305); then the warp
//    softmaxes the row, takes rowsum and ds in place, writes (max, f64 sum,
//    rowsum) of the row to `stats`, and the last sweep sums dq = ds k.
// 2. keys: one block per (KB keys, head, image), K and V of its keys
//    resident as f32. It walks the query rows in index order, QC at a time:
//    recomputes s and dp for its keys (QPT rows x KPT keys per thread), p
//    and ds from the row's stats (the same operations on the same values as
//    pass 1, so the same p and ds), then adds ds^T q and p16^T do into dk
//    and dv held in registers (KPT keys x DPT dims per thread), and writes
//    them once.

#include "common.cuh"

namespace {

using qvt::cp_async16;
using qvt::cp_async_commit;
using qvt::cp_async_wait;
using qvt::mac;
using qvt::round_to;

// pass 1
constexpr int WARPS = 4;                // query rows per block, one per warp
constexpr int MAX_HD = 128;
// pass 2
constexpr int KEY_THREADS = 128;        // 16 key lanes x 8 row (or dim) groups
constexpr int QC = 32;                  // query rows per chunk
constexpr int QPT = QC / 8;             // query rows per thread for s and dp

// keys per shared-memory tile of pass 1: 128 of bf16, 64 of f32 (the same
// bytes; csrc/attention_long.cu's tiles)
template <typename T>
constexpr int KEY_TILE = 256 / static_cast<int>(sizeof(T));

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    long_bwd_rows_kernel(const T* qkv, const T* dout, T* dqkv, double* stats, int N, int H,
                         int hd, int n_valid, float qscale, float scale) {
  constexpr int KT = KEY_TILE<T>;
  constexpr int KPL = KT / 32;                  // keys per lane in a tile
  constexpr int EPC = 16 / sizeof(T);           // elements per 16-byte chunk
  constexpr int EPW = 4 / sizeof(T);            // elements per 32-bit word
  constexpr int WPL = MAX_HD / EPW / 32;        // words of a k row per lane
  extern __shared__ __align__(16) uint8_t smem[];
  const int q0 = blockIdx.x * WARPS, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, hw = hd / EPW;
  const int C = hd / EPC, CS = C + 1;  // 16-byte chunks per row; padded row stride
  const int ns = (N + 3) & ~3;       // row stride of S and P (floats)
  const int ntiles = (N + KT - 1) / KT;
  float* S = reinterpret_cast<float*>(smem);  // [WARPS][ns] scores, then p, then ds
  float* P = S + (size_t)WARPS * ns;          // [WARPS][ns] dp
  float* X = P + (size_t)WARPS * ns;          // [WARPS][hd] scaled q
  float* G = X + WARPS * hd;                  // [WARPS][hd] do (0 for rows >= n_valid)
  uint4* const buf0 = reinterpret_cast<uint4*>(G + WARPS * hd);  // [KT][CS] each
  uint4* const buf1 = buf0 + KT * CS;
  const T* img = qkv + (size_t)b * N * 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = q0 + warp;  // this warp's query row
  float* s = S + (size_t)warp * ns;
  float* dp = P + (size_t)warp * ns;

  // tiles [0, nt): K (scores); [nt, 2nt): V (dp); [2nt, 3nt): K (dq)
  auto load_tile = [&](int tt, uint4* buf) {
    const int k0 = (tt % ntiles) * KT, part = (tt / ntiles == 1) ? 2 : 1;
    const int nk = min(KT, N - k0);
    for (int i = threadIdx.x; i < nk * C; i += blockDim.x) {
      const int j = i / C, c = i % C;
      cp_async16(buf + j * CS + c, img + (size_t)(k0 + j) * 3 * D + part * D + h * hd + EPC * c);
    }
    cp_async_commit();
  };
  load_tile(0, buf0);

  for (int i = threadIdx.x; i < WARPS * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd, row = q0 + r;
    float x = 0.0f, g = 0.0f;
    if (row < N)
      x = round_to<T>(__fmul_rn(qvt::to_f32(img[(size_t)row * 3 * D + h * hd + d]), qscale));
    if (row < n_valid) g = qvt::to_f32(dout[((size_t)b * N + row) * D + h * hd + d]);
    X[i] = x;
    G[i] = g;
  }

  float dq[WPL][EPW];
#pragma unroll
  for (int u = 0; u < WPL; ++u)
#pragma unroll
    for (int e = 0; e < EPW; ++e) dq[u][e] = 0.0f;

  const int total = 3 * ntiles;
  for (int tt = 0; tt < total; ++tt) {
    const uint4* Tb = (tt & 1) ? buf1 : buf0;
    if (tt + 1 < total) {
      load_tile(tt + 1, (tt & 1) ? buf0 : buf1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile tt (and the staged rows) visible to every warp
    const int sweep = tt / ntiles, k0 = (tt % ntiles) * KT, nk = min(KT, N - k0);

    if (sweep < 2) {
      // ---- s = q k^T (sweep 0) or dp = do v^T (sweep 1) over this tile, d in order ----
      const float* x = (sweep == 0 ? X : G) + warp * hd;
      float* out = sweep == 0 ? s : dp;
      float acc[KPL];
#pragma unroll
      for (int t = 0; t < KPL; ++t) acc[t] = 0.0f;
      for (int c = 0; c < C; ++c) {
        float kf[KPL][EPC];
#pragma unroll
        for (int t = 0; t < KPL; ++t)
          qvt::unpack_chunk<T>(Tb[min(lane + 32 * t, nk - 1) * CS + c], kf[t]);
        float xf[EPC];
#pragma unroll
        for (int v = 0; v < EPC / 4; ++v) {
          const float4 x4 = reinterpret_cast<const float4*>(x + EPC * c)[v];
          xf[4 * v] = x4.x;
          xf[4 * v + 1] = x4.y;
          xf[4 * v + 2] = x4.z;
          xf[4 * v + 3] = x4.w;
        }
#pragma unroll
        for (int t = 0; t < KPL; ++t)
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[t] = mac<T>(xf[e], kf[t][e], acc[t]);
      }
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        if (j < nk) out[k0 + j] = (sweep == 0 && k0 + j >= n_valid) ? -1e30f : acc[t];
      }
    } else {
      if (tt == 2 * ntiles) {
        // ---- the row's softmax, rowsum(dp * p) and ds, in place (s, dp complete) ----
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
        double r = 0.0;
        for (int j = lane; j < N; j += 32) {
          const float p = static_cast<float>(static_cast<double>(s[j]) / sum);
          s[j] = p;
          r += static_cast<double>(__fmul_rn(dp[j], p));
        }
        const float rf = static_cast<float>(qvt::warp_sum(r));
        for (int j = lane; j < N; j += 32) s[j] = round_to<T>(__fmul_rn(s[j], __fsub_rn(dp[j], rf)));
        if (lane == 0 && qi < N) {
          double* st = stats + ((size_t)(b * H + h) * N + qi) * 4;
          st[0] = mx;
          st[1] = sum;
          st[2] = rf;
        }
        __syncwarp();
      }
      // ---- dq += ds k over this K tile, keys in order ----
      const uint32_t* Tw = reinterpret_cast<const uint32_t*>(Tb);
      for (int j = 0; j < nk; ++j) {
        const float g = s[k0 + j];
#pragma unroll
        for (int u = 0; u < WPL; ++u) {
          const int w2 = lane + 32 * u;
          if (w2 < hw) {
            float kf[EPW];
            qvt::unpack_word<T>(Tw[j * CS * 4 + w2], kf);
#pragma unroll
            for (int e = 0; e < EPW; ++e) dq[u][e] = mac<T>(g, kf[e], dq[u][e]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with tile tt before its buffer refills
  }

  if (qi < N) {
#pragma unroll
    for (int u = 0; u < WPL; ++u) {
      const int w2 = lane + 32 * u;
      if (w2 >= hw) continue;
      T* at = dqkv + ((size_t)b * N + qi) * 3 * D + h * hd + EPW * w2;
      if constexpr (EPW == 2)
        *reinterpret_cast<__nv_bfloat162*>(at) =
            __floats2bfloat162_rn(__fmul_rn(dq[u][0], scale), __fmul_rn(dq[u][1], scale));
      else
        *at = __fmul_rn(dq[u][0], scale);
    }
  }
}

// DPT: head dims per thread in the dk/dv sums (hd <= 8 * DPT); KPT: keys per
// thread; a block owns KB = 16 * KPT keys.
template <typename T, int DPT, int KPT>
__global__ void __launch_bounds__(KEY_THREADS)
    long_bwd_keys_kernel(const T* qkv, const T* dout, T* dqkv, const double* stats, int N, int H,
                         int hd, int n_valid, float qscale, float scale) {
  constexpr int KB = 16 * KPT;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  extern __shared__ __align__(16) uint8_t smem[];
  const int k0 = blockIdx.x * KB, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, C = hd / EPC;
  const int hs = hd + 4, h4 = hs / 4;  // f32 row stride: 16-byte rows on spread banks
  float* Ks = reinterpret_cast<float*>(smem);  // [KB][hs] k of this block's keys
  float* Vs = Ks + KB * hs;                    // [KB][hs] v
  float* Xs = Vs + KB * hs;                    // [QC][hs] scaled q of the chunk's rows
  float* Qu = Xs + QC * hs;                    // [QC][hs] q
  float* Gs = Qu + QC * hs;                    // [QC][hs] do
  float* DS = Gs + QC * hs;                    // [QC][KB] ds
  float* PS = DS + QC * KB;                    // [QC][KB] T(p)
  double* Ls = reinterpret_cast<double*>(PS + QC * KB);  // [QC] softmax sums
  float* Ms = reinterpret_cast<float*>(Ls + QC);         // [QC] row max
  float* Rs = Ms + QC;                                   // [QC] rowsum(dp * p)
  const T* img = qkv + (size_t)b * N * 3 * D;
  const int t = threadIdx.x, kg = t % 16, grp = t / 16;
  const int d0 = grp * DPT;  // this thread's head dims in the sums

  for (int i = t; i < KB * C; i += KEY_THREADS) {
    const int j = i / C, c = i % C;
    float kf[EPC], vf[EPC];
    if (k0 + j < N) {
      const T* row = img + (size_t)(k0 + j) * 3 * D + h * hd + EPC * c;
      qvt::unpack_chunk<T>(*reinterpret_cast<const uint4*>(row + D), kf);
      qvt::unpack_chunk<T>(*reinterpret_cast<const uint4*>(row + 2 * D), vf);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) kf[e] = vf[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      Ks[j * hs + EPC * c + e] = kf[e];
      Vs[j * hs + EPC * c + e] = vf[e];
    }
  }

  float adk[KPT][DPT], adv[KPT][DPT];
#pragma unroll
  for (int u = 0; u < KPT; ++u)
#pragma unroll
    for (int e = 0; e < DPT; ++e) adk[u][e] = adv[u][e] = 0.0f;

  const float4* K4 = reinterpret_cast<const float4*>(Ks);
  const float4* V4 = reinterpret_cast<const float4*>(Vs);
  const float4* X4 = reinterpret_cast<const float4*>(Xs);
  const float4* Q4 = reinterpret_cast<const float4*>(Qu);
  const float4* G4 = reinterpret_cast<const float4*>(Gs);

  for (int i0 = 0; i0 < n_valid; i0 += QC) {
    const int rows = min(QC, n_valid - i0);
    __syncthreads();  // K, V staged; the previous chunk's sums are done with its rows
    for (int i = t; i < QC * C; i += KEY_THREADS) {
      const int r = i / C, c = i % C;
      float qf[EPC], gf[EPC];
      if (r < rows) {
        qvt::unpack_chunk<T>(
            *reinterpret_cast<const uint4*>(img + (size_t)(i0 + r) * 3 * D + h * hd + EPC * c),
            qf);
        qvt::unpack_chunk<T>(*reinterpret_cast<const uint4*>(
                                 dout + ((size_t)b * N + i0 + r) * D + h * hd + EPC * c),
                             gf);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e) qf[e] = gf[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        Xs[r * hs + EPC * c + e] = round_to<T>(__fmul_rn(qf[e], qscale));
        Qu[r * hs + EPC * c + e] = qf[e];
        Gs[r * hs + EPC * c + e] = gf[e];
      }
    }
    for (int r = t; r < rows; r += KEY_THREADS) {
      const double* st = stats + ((size_t)(b * H + h) * N + i0 + r) * 4;
      Ms[r] = static_cast<float>(st[0]);
      Ls[r] = st[1];
      Rs[r] = static_cast<float>(st[2]);
    }
    __syncthreads();

    // ---- s and dp of QPT rows x KPT keys (d in order), then p and ds ----
    {
      float sa[QPT][KPT], pa[QPT][KPT];
#pragma unroll
      for (int r = 0; r < QPT; ++r)
#pragma unroll
        for (int u = 0; u < KPT; ++u) sa[r][u] = pa[r][u] = 0.0f;
      for (int c4 = 0; c4 < hd / 4; ++c4) {
        float4 kq[KPT], vq[KPT];
#pragma unroll
        for (int u = 0; u < KPT; ++u) {
          kq[u] = K4[(kg + 16 * u) * h4 + c4];
          vq[u] = V4[(kg + 16 * u) * h4 + c4];
        }
#pragma unroll
        for (int r = 0; r < QPT; ++r) {
          const float4 xq = X4[(grp * QPT + r) * h4 + c4];
          const float4 gq = G4[(grp * QPT + r) * h4 + c4];
#pragma unroll
          for (int u = 0; u < KPT; ++u) {
            sa[r][u] = mac<T>(xq.x, kq[u].x, sa[r][u]);
            sa[r][u] = mac<T>(xq.y, kq[u].y, sa[r][u]);
            sa[r][u] = mac<T>(xq.z, kq[u].z, sa[r][u]);
            sa[r][u] = mac<T>(xq.w, kq[u].w, sa[r][u]);
            pa[r][u] = mac<T>(gq.x, vq[u].x, pa[r][u]);
            pa[r][u] = mac<T>(gq.y, vq[u].y, pa[r][u]);
            pa[r][u] = mac<T>(gq.z, vq[u].z, pa[r][u]);
            pa[r][u] = mac<T>(gq.w, vq[u].w, pa[r][u]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < QPT; ++r) {
#pragma unroll
        for (int u = 0; u < KPT; ++u) {
          const int i = grp * QPT + r, j = kg + 16 * u;
          float ds = 0.0f, p16 = 0.0f;
          if (i < rows && k0 + j < N) {
            const float sc = k0 + j < n_valid ? sa[r][u] : -1e30f;
            const float e = static_cast<float>(exp(static_cast<double>(__fsub_rn(sc, Ms[i]))));
            const float p = static_cast<float>(static_cast<double>(e) / Ls[i]);
            ds = round_to<T>(__fmul_rn(p, __fsub_rn(pa[r][u], Rs[i])));
            p16 = round_to<T>(p);
          }
          DS[i * KB + j] = ds;
          PS[i * KB + j] = p16;
        }
      }
    }
    __syncthreads();

    // ---- dk += ds^T q, dv += p16^T do over the chunk's rows, in order ----
    if (d0 < hd) {
      for (int i = 0; i < rows; ++i) {
        float qv[DPT], gv[DPT];
#pragma unroll
        for (int c4 = 0; c4 < DPT / 4; ++c4) {
          float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), g = a;
          if (d0 + 4 * c4 < hd) {
            a = Q4[i * h4 + d0 / 4 + c4];
            g = G4[i * h4 + d0 / 4 + c4];
          }
          qv[4 * c4] = a.x;
          qv[4 * c4 + 1] = a.y;
          qv[4 * c4 + 2] = a.z;
          qv[4 * c4 + 3] = a.w;
          gv[4 * c4] = g.x;
          gv[4 * c4 + 1] = g.y;
          gv[4 * c4 + 2] = g.z;
          gv[4 * c4 + 3] = g.w;
        }
#pragma unroll
        for (int u = 0; u < KPT; ++u) {
          const float ds = DS[i * KB + kg + 16 * u], p16 = PS[i * KB + kg + 16 * u];
#pragma unroll
          for (int e = 0; e < DPT; ++e) {
            adk[u][e] = mac<T>(ds, qv[e], adk[u][e]);
            adv[u][e] = mac<T>(p16, gv[e], adv[u][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < KPT; ++u) {
    const int j = k0 + kg + 16 * u;
    if (j >= N) continue;
    T* row = dqkv + ((size_t)b * N + j) * 3 * D + h * hd;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = d0 + e;
      if (d < hd) {
        row[D + d] = qvt::from_f32<T>(__fmul_rn(adk[u][e], scale));
        row[2 * D + d] = qvt::from_f32<T>(adv[u][e]);
      }
    }
  }
}

template <typename T, int DPT, int KPT>
int launch_keys(const void* qkv, const void* dout, void* dqkv, const void* stats, int B, int N,
                int H, int hd, int n_valid, float qscale, float scale, cudaStream_t stream) {
  constexpr int KB = 16 * KPT;
  const size_t smem = sizeof(float) * (2 * (size_t)KB * (hd + 4) + 3 * (size_t)QC * (hd + 4) +
                                       2 * (size_t)QC * KB) +
                      (sizeof(double) + 2 * sizeof(float)) * QC;
  auto kernel = long_bwd_keys_kernel<T, DPT, KPT>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((N + KB - 1) / KB, H, B), KEY_THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<const double*>(stats), N, H, hd, n_valid, qscale, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* qkv, const void* dout, void* dqkv, void* stats, int B, int N, int H, int hd,
           int n_valid, float qscale, float scale, cudaStream_t st) {
  constexpr int KT = KEY_TILE<T>;
  const size_t smem = sizeof(float) * (2 * (size_t)WARPS * ((N + 3) & ~3) + 2 * (size_t)WARPS * hd) +
                      sizeof(uint4) * 2 * (size_t)KT * (hd * sizeof(T) / 16 + 1);
  cudaError_t e = cudaFuncSetAttribute(long_bwd_rows_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  long_bwd_rows_kernel<T><<<dim3((N + WARPS - 1) / WARPS, H, B), WARPS * 32, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<double*>(stats), N, H, hd, n_valid, qscale, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (hd <= 64)
    return launch_keys<T, 8, 4>(qkv, dout, dqkv, stats, B, N, H, hd, n_valid, qscale, scale, st);
  return launch_keys<T, 16, 2>(qkv, dout, dqkv, stats, B, N, H, hd, n_valid, qscale, scale, st);
}

}  // namespace

// dqkv [B, N, 3*H*hd] f32 of qvt_attention_long for the output gradient do
// [B, N, H*hd] f32 (the bf16 form runs on the tensor cores,
// attention_long_bwd_mma.cu); stats: [B, H, N, 4] f64 scratch (the rows'
// max, softmax sum and rowsum, from pass 1 to pass 2). Two launches on
// `stream`.
extern "C" int qvt_attention_long_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                                      int B, int N, int H, int hd, int n_valid, float qscale,
                                      float scale, void* stream) {
  return launch<float>(qkv, dout, dqkv, stats, B, N, H, hd, n_valid, qscale, scale,
                       static_cast<cudaStream_t>(stream));
}
