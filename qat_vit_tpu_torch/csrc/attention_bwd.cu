// Backward of multi-head attention over the packed qkv, for sm_90a (kernel
// B, K1's backward).
//
// Replaces (TPU, Pallas): qat_vit_tpu/ops/flash_attention_train.py::
// _attention_bwd_kernel (launched by _attention_bwd_call), with and without
// in_fq: the VJP of attention_train and attention_train_fq.
//
// Math, per (image, head), as the TPU kernel: q, k, v are the raw qkv or,
// with in_fq, its fake-quantized values (f32, round half to even, clip, back
// to bf16; scale and zero point from the device pointer qs);
//   s  = (q k^T) * scale          f32 dot, scaled AFTER it in f32 (the
//                                 forward scales q before it, in bf16);
//   keys >= n_valid at -1e30, p = softmax(s) in f32;
//   dp = do v^T                   f32;
//   ds = bf16(p * (dp - rowsum(dp * p)));   p16 = bf16(p);
//   dq = (ds k) * scale,  dk = (ds^T q) * scale,  dv = p16^T do,
// each accumulated in f32 and rounded to bf16 into the packed dqkv
// [B, N, 3*H*hd]. With in_fq the straight-through estimator's mask, recomputed
// from the raw qkv (qmin <= rint(raw / s + zp) <= qmax), zeroes dq, dk and dv
// before the store.
//
// Every rounding is pinned so that the plain version
// (ops/flash_attention_train.attention_bwd_plain) replays it bit for bit:
// all dots multiply bf16 values (exact in f32) and accumulate in f32 in
// index order; exp runs in f64 and is rounded to f32; the softmax sum and
// rowsum(dp * p) (of f32 products) accumulate in f64 and are rounded once.
//
// What bounds it on an H100. Per (image, head) the four products are
// 8*N*N*hd flops; this kernel recomputes the scores and dp once more for the
// key pass, 14*N*N*hd flops in all, on 4*N*hd*2 bytes read and 3*N*hd*2
// written: ~1,300 flops per byte at ViT-S, compute-bound. This first kernel
// runs every product on the CUDA cores (f32 FMA, 67 TFLOP/s peak) and is
// bound by them and by shared-memory reads; mma.sync/wgmma is later work.
//
// Simple design, deterministic without atomics: dk and dv are sums over all
// queries, so one block owns one (image, head) and reduces them itself in
// index order. The block stages q, k, v (fake-quantized when asked) and do of
// its head in shared memory as bf16 rows padded by one 32-bit word (lanes
// reading 32 different rows hit 32 banks): 4 x 197 x 66 x 2 bytes ~ 104 KB at
// ViT-S and ViT-B (hd 64). 8 warps.
//   Pass 1, one warp per query row i: lanes split the keys for s and dp,
//   warp-reduce the max, the softmax sum and rowsum(dp * p), keep (max, sum,
//   rowsum) of row i in shared memory, then split the head dims for dq.
//   Pass 2, one warp per key row j: lanes split the queries and recompute the
//   column of p and ds from the kept row statistics (the same operations in
//   the same order, so the same values), then split the head dims for dk and
//   dv. attention_bwd_smem_bytes in ops/flash_attention_train.py mirrors the
//   layout; the wrapper's gate refuses an N that does not fit.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float bf16_at(const uint32_t* rows, int st, int row, int d) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(rows + (size_t)row * st)[d]);
}

// sum_d x[d] * row[d] in d order (x: f32 values of bf16, row: bf16 pairs)
__device__ __forceinline__ float dot_row(const float* x, const uint32_t* row, int hw) {
  float s = 0.0f;
  for (int w2 = 0; w2 < hw; ++w2) {
    uint32_t w = row[w2];
    const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
    s = fmaf(x[2 * w2], f.x, s);
    s = fmaf(x[2 * w2 + 1], f.y, s);
  }
  return s;
}

template <bool IN_FQ>
__global__ void __launch_bounds__(WARPS * 32)
    attention_bwd_kernel(const __nv_bfloat16* qkv, const __nv_bfloat16* dout, const float* qs,
                         __nv_bfloat16* dqkv, int N, int H, int hd, int n_valid, float scale,
                         float fq_min, float fq_max) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * hd, hw = hd / 2, st = hw + 1;  // words per row; st is odd
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

  const __nv_bfloat16* img = qkv + (size_t)b * N * 3 * D;
  const __nv_bfloat16* gimg = dout + (size_t)b * N * D;
  __nv_bfloat16* dimg = dqkv + (size_t)b * N * 3 * D;
  float fs = 1.0f, fz = 0.0f;
  if (IN_FQ) {
    fs = qs[0];
    fz = qs[1];
  }

  for (int t = threadIdx.x; t < N * hw; t += blockDim.x) {
    const int j = t / hw, w2 = t % hw;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(img + (size_t)j * 3 * D + h * hd);
    uint32_t qw = row[w2], kw = row[D / 2 + w2], vw = row[D + w2];
    if (IN_FQ) {
      qw = qvt::fake_quant_pair(qw, fs, fz, fq_min, fq_max);
      kw = qvt::fake_quant_pair(kw, fs, fz, fq_min, fq_max);
      vw = qvt::fake_quant_pair(vw, fs, fz, fq_min, fq_max);
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

  // the gradient at column col of row r of this image, STE-masked, as bf16
  auto store = [&](int r, int col, float g) {
    const size_t at = (size_t)r * 3 * D + col;
    if (IN_FQ && !qvt::ste_keep(__bfloat162float(img[at]), fs, fz, fq_min, fq_max)) g = 0.0f;
    dimg[at] = __float2bfloat16_rn(g);
  };

  // pass 1: one query row per warp -> row statistics and dq
  for (int i = warp; i < N; i += WARPS) {
    for (int d = lane; d < hd; d += 32) {
      xa[d] = bf16_at(Qs, st, i, d);
      xb[d] = bf16_at(Os, st, i, d);
    }
    __syncwarp();
    float mx = -1e30f;
    for (int j = lane; j < N; j += 32) {
      const float s = j < n_valid ? __fmul_rn(dot_row(xa, Ks + (size_t)j * st, hw), scale)
                                  : -1e30f;
      pa[j] = s;
      pb[j] = dot_row(xb, Vs + (size_t)j * st, hw);
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
      pb[j] = qvt::round_bf16(__fmul_rn(pa[j], __fsub_rn(pb[j], rf)));
    if (lane == 0) {
      Ms[i] = mx;
      Ls[i] = l;
      Rs[i] = rf;
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < N; ++j) acc = fmaf(pb[j], bf16_at(Ks, st, j, d), acc);
      store(i, h * hd + d, __fmul_rn(acc, scale));
    }
    __syncwarp();
  }
  __syncthreads();

  // pass 2: one key row per warp -> the column of p and ds, then dk and dv
  for (int j = warp; j < N; j += WARPS) {
    for (int d = lane; d < hd; d += 32) {
      xa[d] = bf16_at(Ks, st, j, d);
      xb[d] = bf16_at(Vs, st, j, d);
    }
    __syncwarp();
    for (int i = lane; i < N; i += 32) {
      const float s = j < n_valid ? __fmul_rn(dot_row(xa, Qs + (size_t)i * st, hw), scale)
                                  : -1e30f;
      const float e = static_cast<float>(exp(static_cast<double>(__fsub_rn(s, Ms[i]))));
      const float p = static_cast<float>(static_cast<double>(e) / Ls[i]);
      const float dp = dot_row(xb, Os + (size_t)i * st, hw);
      pa[i] = qvt::round_bf16(p);
      pb[i] = qvt::round_bf16(__fmul_rn(p, __fsub_rn(dp, Rs[i])));
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float ak = 0.0f, av = 0.0f;
      for (int i = 0; i < N; ++i) {
        ak = fmaf(pb[i], bf16_at(Qs, st, i, d), ak);
        av = fmaf(pa[i], bf16_at(Os, st, i, d), av);
      }
      store(j, D + h * hd + d, __fmul_rn(ak, scale));
      store(j, 2 * D + h * hd + d, av);
    }
    __syncwarp();
  }
}

template <bool IN_FQ>
int launch(const void* qkv, const void* dout, const void* qs, void* dqkv, int B, int N, int H,
           int hd, int n_valid, float scale, float fq_min, float fq_max, void* stream) {
  const size_t smem = sizeof(uint32_t) * 4 * (size_t)N * (hd / 2 + 1) +
                      (sizeof(double) + 2 * sizeof(float)) * (size_t)N +
                      sizeof(float) * 2 * ((size_t)WARPS * N + (size_t)WARPS * hd);
  const cudaError_t e = cudaFuncSetAttribute(attention_bwd_kernel<IN_FQ>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_bwd_kernel<IN_FQ><<<dim3(H, B), WARPS * 32, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(qs), static_cast<__nv_bfloat16*>(dqkv), N, H, hd, n_valid,
      scale, fq_min, fq_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dqkv [B, N, 3*H*hd] bf16 from qkv (raw) and do; in_fq != 0 fake-quantizes
// q, k, v with (qs[0], qs[1], fq_min, fq_max) and applies the STE mask
extern "C" int qvt_attention_bwd(const void* qkv, const void* dout, const void* qs, void* dqkv,
                                 int B, int N, int H, int hd, int n_valid, float scale,
                                 int in_fq, float fq_min, float fq_max, void* stream) {
  if (in_fq)
    return launch<true>(qkv, dout, qs, dqkv, B, N, H, hd, n_valid, scale, fq_min, fq_max,
                        stream);
  return launch<false>(qkv, dout, nullptr, dqkv, B, N, H, hd, n_valid, scale, 0.0f, 0.0f,
                       stream);
}
