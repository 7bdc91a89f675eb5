// Backward of multi-head attention over the packed f32 qkv on the CUDA
// cores, for sm_90a (kernel B, K1's backward, in f32).
//
// Replaces (TPU, Pallas): qat_vit_tpu/ops/flash_attention_train.py::
// _attention_bwd_kernel (launched by _attention_bwd_call), with and without
// in_fq, for an f32 qkv: the VJP of attention_train and attention_train_fq.
// The bf16 form runs on the tensor cores (csrc/attention_bwd_mma.cu).
//
// Math, per (image, head), as the TPU kernel (T the qkv type; this file
// launches T = f32): q, k, v are the raw qkv or, with in_fq, its
// fake-quantized values (f32, round half to even, clip, back to T; scale
// and zero point from the device pointer qs);
//   s  = (q k^T) * scale          f32 dot, scaled AFTER it in f32 (the
//                                 forward scales q before it, in T);
//   keys >= n_valid at -1e30, p = softmax(s) in f32;
//   dp = do v^T                   f32;
//   ds = T(p * (dp - rowsum(dp * p)));   p16 = T(p)   (no-ops for f32);
//   dq = (ds k) * scale,  dk = (ds^T q) * scale,  dv = p16^T do,
// each accumulated in f32 and rounded to T into the packed dqkv
// [B, N, 3*H*hd]. With in_fq the straight-through estimator's mask, recomputed
// from the raw qkv (qmin <= rint(raw / s + zp) <= qmax), zeroes dq, dk and dv
// before the store.
//
// Every rounding is pinned so that the plain version
// (ops/flash_attention_train.attention_bwd_plain) replays it bit for bit:
// all dots accumulate in f32 in index order through mac<T> (an FMA of exact
// bf16 products, or __fmul_rn then __fadd_rn for f32); exp runs in f64 and
// is rounded to f32; the softmax sum and rowsum(dp * p) (of f32 products)
// accumulate in f64 and are rounded once.
//
// What bounds it on an H100. Per (image, head) the four products are
// 8*N*N*hd flops; this kernel recomputes the scores and dp once more for the
// key pass, 14*N*N*hd flops in all, on 4*N*hd*4 bytes read and 3*N*hd*4
// written: compute-bound. It runs every product on the CUDA cores (f32 FMA,
// 67 TFLOP/s peak), bound by them and by shared-memory reads; the f32 form
// is off the main path (f32 models), so it stays simple.
//
// Simple design, deterministic without atomics: dk and dv are sums over all
// queries, so one block owns one (image, head) and reduces them itself in
// index order, 8 warps.
// - Resident, where q, k, v and do of the head fit: the block stages them
//   in shared memory as rows of T padded by one 32-bit word (lanes reading
//   32 different rows hit 32 banks): 4 x 197 x 65 words ~ 205 KB at ViT-S
//   and ViT-B (hd 64), so N <= 203 at hd 64.
//   Pass 1, one warp per query row i: lanes split the keys for s and dp,
//   warp-reduce the max, the softmax sum and rowsum(dp * p), keep (max, sum,
//   rowsum) of row i in shared memory, then split the head dims for dq.
//   Pass 2, one warp per key row j: lanes split the queries and recompute the
//   column of p and ds from the kept row statistics (the same operations in
//   the same order, so the same values), then split the head dims for dk and
//   dv.
// - Streamed, past that (any N JAX's K1 gate admits): the same passes in
//   rounds of 8 rows, one per warp, with the other operands passing through
//   shared memory in tiles of 32 rows (k and v in pass 1, q and do in pass
//   2), once for the score and dp row and once more for the head-dim sums;
//   every sum keeps the resident form's order, so the same bits.
// attention_bwd_smem_bytes in ops/flash_attention_train.py mirrors both
// layouts.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;

// element d of row `row` of a staged [N][st]-word array of T, as f32
template <typename T>
__device__ __forceinline__ float elem_at(const uint32_t* rows, int st, int row, int d) {
  return qvt::to_f32(reinterpret_cast<const T*>(rows + (size_t)row * st)[d]);
}

// sum_d x[d] * row[d] in d order (x: f32 values of T, row: words of T)
template <typename T>
__device__ __forceinline__ float dot_row(const float* x, const uint32_t* row, int hw) {
  constexpr int EPW = 4 / sizeof(T);
  float s = 0.0f;
  for (int w2 = 0; w2 < hw; ++w2) {
    float f[EPW];
    qvt::unpack_word<T>(row[w2], f);
#pragma unroll
    for (int e = 0; e < EPW; ++e) s = qvt::mac<T>(x[EPW * w2 + e], f[e], s);
  }
  return s;
}

template <typename T, bool IN_FQ>
__global__ void __launch_bounds__(WARPS * 32)
    attention_bwd_kernel(const T* qkv, const T* dout, const float* qs, T* dqkv, int N, int H,
                         int hd, int n_valid, float scale, float fq_min, float fq_max) {
  using qvt::mac;
  using qvt::round_to;
  using qvt::to_f32;
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * hd, hw = hd * (int)sizeof(T) / 4, st = hw + 1;  // words per row; st is odd
  uint32_t* Qs = reinterpret_cast<uint32_t*>(smem);  // [N][st]
  uint32_t* Ks = Qs + (size_t)N * st;                // [N][st]
  uint32_t* Vs = Ks + (size_t)N * st;                // [N][st]
  uint32_t* Os = Vs + (size_t)N * st;                // [N][st] do
  double* Ls = reinterpret_cast<double*>(Os + (size_t)N * st);  // [N] softmax sums
  float* Ms = reinterpret_cast<float*>(Ls + N);      // [N] row max
  float* Rs = Ms + N;                                // [N] rowsum(dp * p)
  float* Wa = Rs + N;                                // [WARPS][N]
  float* Wb = Wa + (size_t)WARPS * N;                // [WARPS][N]
  float* Wx = Wb + (size_t)WARPS * N;                // [WARPS][hd]
  float* Wy = Wx + (size_t)WARPS * hd;               // [WARPS][hd]

  const T* img = qkv + (size_t)b * N * 3 * D;
  const T* gimg = dout + (size_t)b * N * D;
  T* dimg = dqkv + (size_t)b * N * 3 * D;
  float fs = 1.0f, fz = 0.0f;
  if (IN_FQ) {
    fs = qs[0];
    fz = qs[1];
  }

  const int dw = D * (int)sizeof(T) / 4;  // words per third of a qkv row
  for (int t = threadIdx.x; t < N * hw; t += blockDim.x) {
    const int j = t / hw, w2 = t % hw;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(img + (size_t)j * 3 * D + h * hd);
    uint32_t qw = row[w2], kw = row[dw + w2], vw = row[2 * dw + w2];
    if (IN_FQ) {
      qw = qvt::fake_quant_word<T>(qw, fs, fz, fq_min, fq_max);
      kw = qvt::fake_quant_word<T>(kw, fs, fz, fq_min, fq_max);
      vw = qvt::fake_quant_word<T>(vw, fs, fz, fq_min, fq_max);
    }
    Qs[j * st + w2] = qw;
    Ks[j * st + w2] = kw;
    Vs[j * st + w2] = vw;
    Os[j * st + w2] = reinterpret_cast<const uint32_t*>(gimg + (size_t)j * D + h * hd)[w2];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pa = Wa + (size_t)warp * N;
  float* pb = Wb + (size_t)warp * N;
  float* xa = Wx + (size_t)warp * hd;
  float* xb = Wy + (size_t)warp * hd;

  // the gradient at column col of row r of this image, STE-masked, as T
  auto store = [&](int r, int col, float g) {
    const size_t at = (size_t)r * 3 * D + col;
    if (IN_FQ && !qvt::ste_keep(to_f32(img[at]), fs, fz, fq_min, fq_max)) g = 0.0f;
    dimg[at] = qvt::from_f32<T>(g);
  };

  // pass 1: one query row per warp -> row statistics and dq
  for (int i = warp; i < N; i += WARPS) {
    for (int d = lane; d < hd; d += 32) {
      xa[d] = elem_at<T>(Qs, st, i, d);
      xb[d] = elem_at<T>(Os, st, i, d);
    }
    __syncwarp();
    float mx = -1e30f;
    for (int j = lane; j < N; j += 32) {
      const float s = j < n_valid ? __fmul_rn(dot_row<T>(xa, Ks + (size_t)j * st, hw), scale)
                                  : -1e30f;
      pa[j] = s;
      pb[j] = dot_row<T>(xb, Vs + (size_t)j * st, hw);
      mx = fmaxf(mx, s);
    }
    mx = qvt::warp_max(mx);
    double l = 0.0;
    for (int j = lane; j < N; j += 32) {
      const float e = static_cast<float>(exp(static_cast<double>(__fsub_rn(pa[j], mx))));
      pa[j] = e;
      l += static_cast<double>(e);
    }
    l = qvt::warp_sum(l);
    double r = 0.0;
    for (int j = lane; j < N; j += 32) {
      const float p = static_cast<float>(static_cast<double>(pa[j]) / l);
      pa[j] = p;
      r += static_cast<double>(__fmul_rn(pb[j], p));
    }
    const float rf = static_cast<float>(qvt::warp_sum(r));
    for (int j = lane; j < N; j += 32)
      pb[j] = round_to<T>(__fmul_rn(pa[j], __fsub_rn(pb[j], rf)));
    if (lane == 0) {
      Ms[i] = mx;
      Ls[i] = l;
      Rs[i] = rf;
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < N; ++j) acc = mac<T>(pb[j], elem_at<T>(Ks, st, j, d), acc);
      store(i, h * hd + d, __fmul_rn(acc, scale));
    }
    __syncwarp();
  }
  __syncthreads();

  // pass 2: one key row per warp -> the column of p and ds, then dk and dv
  for (int j = warp; j < N; j += WARPS) {
    for (int d = lane; d < hd; d += 32) {
      xa[d] = elem_at<T>(Ks, st, j, d);
      xb[d] = elem_at<T>(Vs, st, j, d);
    }
    __syncwarp();
    for (int i = lane; i < N; i += 32) {
      const float s = j < n_valid ? __fmul_rn(dot_row<T>(xa, Qs + (size_t)i * st, hw), scale)
                                  : -1e30f;
      const float e = static_cast<float>(exp(static_cast<double>(__fsub_rn(s, Ms[i]))));
      const float p = static_cast<float>(static_cast<double>(e) / Ls[i]);
      const float dp = dot_row<T>(xb, Os + (size_t)i * st, hw);
      pa[i] = round_to<T>(p);
      pb[i] = round_to<T>(__fmul_rn(p, __fsub_rn(dp, Rs[i])));
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float ak = 0.0f, av = 0.0f;
      for (int i = 0; i < N; ++i) {
        ak = mac<T>(pb[i], elem_at<T>(Qs, st, i, d), ak);
        av = mac<T>(pa[i], elem_at<T>(Os, st, i, d), av);
      }
      store(j, D + h * hd + d, __fmul_rn(ak, scale));
      store(j, 2 * D + h * hd + d, av);
    }
    __syncwarp();
  }
}

// rows of a streamed tile (STREAM form): one key (pass 1) or query (pass 2)
// per lane
constexpr int TR = 32;

// the streamed form: per round, one query row (pass 1) or key row (pass 2)
// per warp; the other operands in TR-row tiles
template <typename T, bool IN_FQ>
__global__ void __launch_bounds__(WARPS * 32)
    attention_bwd_stream_kernel(const T* qkv, const T* dout, const float* qs, T* dqkv, int N,
                                int H, int hd, int n_valid, float scale, float fq_min,
                                float fq_max) {
  using qvt::mac;
  using qvt::round_to;
  using qvt::to_f32;
  constexpr int EPW = 4 / sizeof(T);
  constexpr int DU = 128 / 32;  // head dims per lane (hd <= 128)
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * hd, hw = hd * (int)sizeof(T) / 4, st = hw + 1;
  uint32_t* Ta = reinterpret_cast<uint32_t*>(smem);  // [TR][st] k (pass 1), q (pass 2)
  uint32_t* Tb = Ta + (size_t)TR * st;               // [TR][st] v (pass 1), do (pass 2)
  double* Ls = reinterpret_cast<double*>(Tb + (size_t)TR * st);  // [N] softmax sums
  float* Ms = reinterpret_cast<float*>(Ls + N);      // [N] row max
  float* Rs = Ms + N;                                // [N] rowsum(dp * p)
  float* Wa = Rs + N;                                // [WARPS][N]
  float* Wb = Wa + (size_t)WARPS * N;                // [WARPS][N]
  float* Wx = Wb + (size_t)WARPS * N;                // [WARPS][hd]
  float* Wy = Wx + (size_t)WARPS * hd;               // [WARPS][hd]

  const T* img = qkv + (size_t)b * N * 3 * D + h * hd;
  const T* gimg = dout + (size_t)b * N * D + h * hd;
  T* dimg = dqkv + (size_t)b * N * 3 * D;
  const T* raw = qkv + (size_t)b * N * 3 * D;
  float fs = 1.0f, fz = 0.0f;
  if (IN_FQ) {
    fs = qs[0];
    fz = qs[1];
  }
  const auto word = [&](const T* row, int w2, bool fq) {  // (fake-quantized) word w2 of row
    const uint32_t w = reinterpret_cast<const uint32_t*>(row)[w2];
    return IN_FQ && fq ? qvt::fake_quant_word<T>(w, fs, fz, fq_min, fq_max) : w;
  };
  // rows [r0, r0 + TR) of (a: section sa of qkv, b: sb of qkv, or do when
  // sb < 0) into Ta and Tb, zero past N; sections fake-quantized
  const auto stage = [&](int sa, int sb, int r0) {
    __syncthreads();  // every warp done with the previous tiles
    for (int t = threadIdx.x; t < TR * hw; t += blockDim.x) {
      const int j = t / hw, w2 = t % hw, r = r0 + j;
      uint32_t wa = 0u, wb = 0u;
      if (r < N) {
        wa = word(img + (size_t)r * 3 * D + sa * D, w2, true);
        wb = sb < 0 ? word(gimg + (size_t)r * D, w2, false)
                    : word(img + (size_t)r * 3 * D + sb * D, w2, true);
      }
      Ta[j * st + w2] = wa;
      Tb[j * st + w2] = wb;
    }
    __syncthreads();
  };
  // row r of section sec (or do when sec < 0) as f32 into x
  const auto load_row = [&](float* x, int sec, int r) {
    for (int w2 = threadIdx.x & 31; w2 < hw; w2 += 32) {
      float f[EPW];
      qvt::unpack_word<T>(sec < 0 ? word(gimg + (size_t)r * D, w2, false)
                                  : word(img + (size_t)r * 3 * D + sec * D, w2, true),
                          f);
#pragma unroll
      for (int e = 0; e < EPW; ++e) x[EPW * w2 + e] = f[e];
    }
  };
  auto store = [&](int r, int col, float g) {
    const size_t at = (size_t)r * 3 * D + col;
    if (IN_FQ && !qvt::ste_keep(to_f32(raw[at]), fs, fz, fq_min, fq_max)) g = 0.0f;
    dimg[at] = qvt::from_f32<T>(g);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pa = Wa + (size_t)warp * N;
  float* pb = Wb + (size_t)warp * N;
  float* xa = Wx + (size_t)warp * hd;
  float* xb = Wy + (size_t)warp * hd;

  // pass 1: one query row per warp and round -> row statistics and dq
  for (int r0 = 0; r0 < N; r0 += WARPS) {
    const int i = r0 + warp;
    const bool act = i < N;
    if (act) {
      load_row(xa, 0, i);
      load_row(xb, -1, i);
    }
    __syncwarp();
    for (int k0 = 0; k0 < N; k0 += TR) {
      stage(1, 2, k0);
      const int j = k0 + lane;
      if (act && j < N) {
        pa[j] = j < n_valid ? __fmul_rn(dot_row<T>(xa, Ta + (size_t)lane * st, hw), scale)
                            : -1e30f;
        pb[j] = dot_row<T>(xb, Tb + (size_t)lane * st, hw);
      }
    }
    if (act) {
      float mx = -1e30f;
      for (int j = lane; j < N; j += 32) mx = fmaxf(mx, pa[j]);
      mx = qvt::warp_max(mx);
      double l = 0.0;
      for (int j = lane; j < N; j += 32) {
        const float e = static_cast<float>(exp(static_cast<double>(__fsub_rn(pa[j], mx))));
        pa[j] = e;
        l += static_cast<double>(e);
      }
      l = qvt::warp_sum(l);
      double r = 0.0;
      for (int j = lane; j < N; j += 32) {
        const float p = static_cast<float>(static_cast<double>(pa[j]) / l);
        pa[j] = p;
        r += static_cast<double>(__fmul_rn(pb[j], p));
      }
      const float rf = static_cast<float>(qvt::warp_sum(r));
      for (int j = lane; j < N; j += 32)
        pb[j] = round_to<T>(__fmul_rn(pa[j], __fsub_rn(pb[j], rf)));
      if (lane == 0) {
        Ms[i] = mx;
        Ls[i] = l;
        Rs[i] = rf;
      }
    }
    __syncwarp();
    float acc[DU] = {};
    for (int k0 = 0; k0 < N; k0 += TR) {
      stage(1, 2, k0);
      if (act) {
        const int k1 = min(k0 + TR, N);
#pragma unroll
        for (int u = 0; u < DU; ++u) {
          const int d = lane + 32 * u;
          if (d >= hd) continue;
          for (int j = k0; j < k1; ++j)
            acc[u] = mac<T>(pb[j], elem_at<T>(Ta, st, j - k0, d), acc[u]);
        }
      }
    }
    if (act) {
#pragma unroll
      for (int u = 0; u < DU; ++u)
        if (lane + 32 * u < hd) store(i, h * hd + lane + 32 * u, __fmul_rn(acc[u], scale));
    }
    __syncwarp();
  }
  __syncthreads();  // every row's statistics

  // pass 2: one key row per warp and round -> the column of p and ds, then dk and dv
  for (int r0 = 0; r0 < N; r0 += WARPS) {
    const int j = r0 + warp;
    const bool act = j < N;
    if (act) {
      load_row(xa, 1, j);
      load_row(xb, 2, j);
    }
    __syncwarp();
    for (int q0 = 0; q0 < N; q0 += TR) {
      stage(0, -1, q0);
      const int i = q0 + lane;
      if (act && i < N) {
        const float s = j < n_valid
                            ? __fmul_rn(dot_row<T>(xa, Ta + (size_t)lane * st, hw), scale)
                            : -1e30f;
        const float e = static_cast<float>(exp(static_cast<double>(__fsub_rn(s, Ms[i]))));
        const float p = static_cast<float>(static_cast<double>(e) / Ls[i]);
        const float dp = dot_row<T>(xb, Tb + (size_t)lane * st, hw);
        pa[i] = round_to<T>(p);
        pb[i] = round_to<T>(__fmul_rn(p, __fsub_rn(dp, Rs[i])));
      }
    }
    __syncwarp();
    float ak[DU] = {}, av[DU] = {};
    for (int q0 = 0; q0 < N; q0 += TR) {
      stage(0, -1, q0);
      if (act) {
        const int q1 = min(q0 + TR, N);
#pragma unroll
        for (int u = 0; u < DU; ++u) {
          const int d = lane + 32 * u;
          if (d >= hd) continue;
          for (int i = q0; i < q1; ++i) {
            ak[u] = mac<T>(pb[i], elem_at<T>(Ta, st, i - q0, d), ak[u]);
            av[u] = mac<T>(pa[i], elem_at<T>(Tb, st, i - q0, d), av[u]);
          }
        }
      }
    }
    if (act) {
#pragma unroll
      for (int u = 0; u < DU; ++u) {
        const int d = lane + 32 * u;
        if (d >= hd) continue;
        store(j, D + h * hd + d, __fmul_rn(ak[u], scale));
        store(j, 2 * D + h * hd + d, av[u]);
      }
    }
    __syncwarp();
  }
}

// H100: the dynamic shared memory one block may opt into (bytes)
constexpr size_t SMEM_MAX = 232448;

template <typename T, bool IN_FQ>
int launch(const void* qkv, const void* dout, const void* qs, void* dqkv, int B, int N, int H,
           int hd, int n_valid, float scale, float fq_min, float fq_max, void* stream) {
  const size_t st = hd * sizeof(T) / 4 + 1;  // words per staged row
  const size_t stats = (sizeof(double) + 2 * sizeof(float)) * (size_t)N;
  const size_t rows = sizeof(float) * 2 * ((size_t)WARPS * N + (size_t)WARPS * hd);
  const size_t resident = sizeof(uint32_t) * 4 * (size_t)N * st + stats + rows;
  const bool stream_form = resident > SMEM_MAX;
  const size_t smem = stream_form ? sizeof(uint32_t) * 2 * TR * st + stats + rows : resident;
  auto kernel =
      stream_form ? attention_bwd_stream_kernel<T, IN_FQ> : attention_bwd_kernel<T, IN_FQ>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(H, B), WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<const float*>(qs),
      static_cast<T*>(dqkv), N, H, hd, n_valid, scale, fq_min, fq_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dqkv [B, N, 3*H*hd] f32 from the f32 qkv (raw) and do; in_fq != 0
// fake-quantizes q, k, v with (qs[0], qs[1], fq_min, fq_max) and applies the
// STE mask; hd a multiple of 8 up to 128
extern "C" int qvt_attention_bwd(const void* qkv, const void* dout, const void* qs, void* dqkv,
                                 int B, int N, int H, int hd, int n_valid, float scale,
                                 int in_fq, float fq_min, float fq_max, void* stream) {
  if (hd <= 0 || hd > 128 || hd % 8 || N <= 0 || n_valid <= 0 || n_valid > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_fq)
    return launch<float, true>(qkv, dout, qs, dqkv, B, N, H, hd, n_valid, scale, fq_min, fq_max,
                               stream);
  return launch<float, false>(qkv, dout, nullptr, dqkv, B, N, H, hd, n_valid, scale, 0.0f, 0.0f,
                              stream);
}
