// Multi-head attention over the packed f32 qkv on the CUDA cores, for
// sm_90a: kernel A (K1's forward) and kernel B (K1's backward) of f32
// models, register-tiled, many blocks per head, bit-identical to their
// plain versions.
//
// Replaces (TPU, Pallas), for an f32 qkv, with and without in_fq:
// - qat_vit_tpu/ops/flash_attention.py::_fused_attention_kernel with
//   quantize=False (kernel A), as qat_vit_tpu/ops/flash_attention_train.py's
//   attention_train and attention_train_fq launch it;
// - qat_vit_tpu/ops/flash_attention_train.py::_attention_bwd_kernel
//   (launched by _attention_bwd_call; kernel B), their VJP.
// The bf16 forms run on the tensor cores (attention_q_mma.cu,
// attention_bwd_mma.cu).
//
// Math, per (image, head), as the TPU kernels. q, k, v are the raw qkv or,
// with in_fq, its fake-quantized values (f32, round half to even, clip;
// scale and zero point from the device pointer qs).
//   kernel A: s = (q * scale) k^T, q scaled in f32 BEFORE the dot;
//             keys >= n_valid at -1e30; p = softmax(s); o = p v.
//   kernel B: s = (q k^T) * scale, scaled in f32 AFTER the dot; p as above;
//             dp = do v^T; r = rowsum(dp * p); ds = p * (dp - r);
//             dq = (ds k) * scale, dk = (ds^T q) * scale, dv = p^T do;
//             with in_fq the straight-through estimator's mask, recomputed
//             from the raw qkv (qmin <= rint(raw / s + zp) <= qmax), zeroes
//             dq, dk and dv at the store.
// Every rounding is the plain versions' (ops/flash_attention.
// attention_fwd_plain, ops/flash_attention_train.attention_bwd_plain), so
// the outputs are the same bits: each f32 dot accumulates from +0 in index
// order through mac<float> (__fmul_rn, then __fadd_rn: no contraction), over
// d for s and dp, over j for o and dq, over i for dk and dv; exp runs in f64
// on the f32 difference to the row max and is rounded to f32; the softmax
// sum and rowsum(dp * p) (of f32 products) run in f64 and are rounded once;
// p = f32(f64(e) / l). Zero rows and columns padded onto a dot add +0,
// which leaves an f32 sum unchanged; masked keys have p = 0 exactly.
//
// What bounds it on an H100. Kernel A does 4*N*N*hd flops per (image,
// head), kernel B 10*N*N*hd (s, dp, dq, dk, dv), on 4*N*hd*4 and 7*N*hd*4
// bytes: compute-bound at 67 TFLOP/s for f32 on the CUDA cores. The
// pinned multiply-then-add costs two instructions a product, so half that
// rate is the ceiling; the tensor cores (TF32, 3xTF32) would change the
// bits, and a user picks an f32 model for f32 numerics. Kernel B's keys
// pass recomputes s and dp (14*N*N*hd in all), the price of having no
// atomics: dk and dv are sums over every query, and atomic sums change from
// run to run.
//
// Design: register tiles on many blocks. Every product is one of two
// shared-memory micro-GEMMs on 256 threads:
// - G1 (s and dp, over d): a group of 4 warps computes a 32 x 64 tile, each
//   thread a 4 x 4 register tile (rows ty + 4m, columns tx + 8c of its
//   warp's 16 x 32 slab), 16-byte loads along d: 8 loads feed 64
//   multiply-adds. Operand rows are padded to hd + 4 words, so the 4 row
//   and 8 column loads of a warp hit distinct banks.
// - G2 (o, dq, dk, dv, over keys or queries): a thread owns MR rows x 4
//   consecutive head dims; the A operand is read 4 keys at a time from a
//   row of p or ds, the B operand 4 dims at a time from a row of v, k, q or
//   do. MR = 2 for hd <= 64, 4 above (hd / 4 threads per row).
// Kernel A: one block per (R queries, head, image). Sweep 1 stages K in
// 128-key tiles (both groups of G1) and writes the scores into a
// [R][~N] strip in shared memory; one warp per row takes the max, the f64
// sum and p in place; sweep 2 stages V in 128-key tiles for o = p v (G2).
// Kernel B, two launches:
// 1. rows: one block per (R query rows, head, image), q and do staged; per
//    64-key tile K and V are staged and G1 writes s (group 0) and dp
//    (group 1) into two strips; one warp per row then forms max, l, p, r
//    and ds in place and writes (m, l, r) to a [3, B, H, N] f64 scratch;
//    a second sweep stages K in 128-key tiles for dq = ds k (G2).
// 2. keys: one block per (32 keys, head, image), its K and V resident; q,
//    do and the row statistics stream through in 64-query tiles, in query
//    order: G1 gives s^T and dp^T, every thread then forms p^T and ds^T
//    from the statistics, and G2 adds dk += ds^T q and dv += p^T do.
// R is the largest of 32, 16, .., 1 whose strips fit in the shared memory
// (attention_f32_rows in ops/flash_attention.py mirrors the plans), so any
// N up to ~18,000 at hd 128. Tiles are staged by 16-byte loads, several in
// flight per thread (the wrappers require 16-byte aligned qkv and do).
// Kernel A and the keys pass ask for 3 blocks per SM at hd <= 64 (their
// plans fit 3 at ViT's 197 tokens), the rows pass (~101 KB there) for 2.
// With in_fq each staged K / V / q element is fake-quantized on its way in
// (an IEEE division each): kernel A stages K and V once per block, kernel
// B's rows pass K twice and V once, its keys pass q once per block, so a
// head's K and V are fake-quantized once per block of R rows.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KT = 64;      // keys per G1 tile (one group of 4 warps)
constexpr int C_KEYS = 32;  // keys per block of kernel B's keys pass
constexpr int QT = 64;      // queries per tile of the keys pass
constexpr int NQ = QT + 8;  // row stride of the keys pass's [C_KEYS][QT] tiles (8 mod 32)
constexpr size_t SMEM_MAX = 232448;  // H100: the dynamic shared memory one block may opt into

// words per staged operand row (16-byte aligned; 4 mod 32 for hd % 8 == 0)
__host__ __device__ inline int op_ld(int hd) { return hd + 4; }
// words per strip row: N rounded up to 4 (zero-padded for G2's 4-key
// loads), then to 8 mod 32 (conflict-free G1 stores)
__host__ __device__ inline int strip_ld(int N) {
  const int n4 = (N + 3) & ~3;
  return n4 + ((8 - n4) & 31);
}
// rows allocated for a G1 A operand of R rows (a warp reads a 16-row slab)
__host__ __device__ inline int a_rows(int R) { return R > 16 ? R : 16; }

struct FqArgs {
  float s, z, lo, hi;
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [0, nr) of a head's [*, hd] section into dst [nr][ld]: row r from
// src + r * stride through f when r < nvalid, zero past it. 16-byte loads
// and stores (the wrappers require 16-byte aligned qkv and do; hd, D and
// 3 D are multiples of 4): hd / 4 threads per row, and each thread issues
// the loads of SU rows before it stores any (a 128-row tile at hd 64 in
// two round trips to memory; 8 in flight cost the register-bound rows
// pass more than they saved, port_scripts/k1f32_variants.py).
constexpr int SU = 4;
template <typename F>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, size_t stride, int nr,
                                      int nvalid, int hd, F f) {
  const int nc = hd >> 2, rstep = THREADS / nc, t = threadIdx.x;
  if (t >= rstep * nc) return;
  const int r1 = t / nc, c = (t - r1 * nc) * 4;
  for (int r0 = r1; r0 < nr; r0 += rstep * SU) {
    float4 v[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int r = r0 + u * rstep;
      v[u] = r < nvalid ? *reinterpret_cast<const float4*>(src + (size_t)r * stride + c)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int r = r0 + u * rstep;
      if (r >= nr) continue;
      if (r < nvalid) v[u] = make_float4(f(v[u].x), f(v[u].y), f(v[u].z), f(v[u].w));
      *reinterpret_cast<float4*>(dst + r * ld + c) = v[u];
    }
  }
}

// G1 (header): out[r][c] = sum_d A[r][d] * B[c][d] for r < rows, c < cols
// of a 32 x 64 tile, on one group of 4 warps (g4: the thread's index in
// it); emit(r, c, value) takes each result of the thread's 4 x 4 tile.
template <typename Emit>
__device__ __forceinline__ void g1(const float* A, const float* B, int ld, int hd, int rows,
                                   int cols, int g4, Emit emit) {
  const int w = g4 >> 5, lane = g4 & 31;
  const int r0 = (w & 1) * 16, c0 = (w >> 1) * 32;
  if (r0 >= rows || c0 >= cols) return;  // the warp's slab is empty
  const int ty = lane >> 3, tx = lane & 7;
  const float* a = A + (r0 + ty) * ld;
  const float* b = B + (c0 + tx) * ld;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;
  for (int d = 0; d < hd; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) av[m] = lds4(a + 4 * m * ld + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = lds4(b + 8 * c * ld + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[m][c] = qvt::mac<float>(comp(av[m], e), comp(bv[c], e), acc[m][c]);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) emit(r0 + ty + 4 * m, c0 + tx + 8 * c, acc[m][c]);
}

// G2's thread map: hd / 4 consecutive threads per row, each 4 consecutive
// dims (d0); rows slot + slots * m (r(m)), clamped to the last of `rows`
// allocated rows in row[m] (a clamped row is recomputed and never stored)
template <int MR>
struct G2Map {
  bool act;
  int d0, slot, slots, row[MR];
  __device__ G2Map(int hd, int rows) {
    const int ndg = hd >> 2, t = threadIdx.x;
    slots = THREADS / ndg;
    slot = t / ndg;
    d0 = (t - slot * ndg) * 4;
    act = t < slots * ndg && slot < rows;
#pragma unroll
    for (int m = 0; m < MR; ++m) row[m] = min(slot + slots * m, rows - 1);
  }
  __device__ int r(int m) const { return slot + slots * m; }
};

// G2 (header): acc[n][m][c] += sum_{k < kn} A[n][row_m][k] * B[n][k][d0 + c]
// in k order, for NM products that share their rows; kn a multiple of 4
template <int NM, int MR>
__device__ __forceinline__ void g2(const float* const (&A)[NM], int lda, const G2Map<MR>& map,
                                   const float* const (&B)[NM], int ldb, int kn,
                                   float (&acc)[NM][MR][4]) {
  for (int k = 0; k < kn; k += 4) {
    float4 a[NM][MR];
#pragma unroll
    for (int n = 0; n < NM; ++n)
#pragma unroll
      for (int m = 0; m < MR; ++m) a[n][m] = lds4(A[n] + map.row[m] * lda + k);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int n = 0; n < NM; ++n) {
        const float4 bv = lds4(B[n] + (k + e) * ldb + map.d0);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float x = comp(a[n][m], e);
          acc[n][m][0] = qvt::mac<float>(x, bv.x, acc[n][m][0]);
          acc[n][m][1] = qvt::mac<float>(x, bv.y, acc[n][m][1]);
          acc[n][m][2] = qvt::mac<float>(x, bv.z, acc[n][m][2]);
          acc[n][m][3] = qvt::mac<float>(x, bv.w, acc[n][m][3]);
        }
      }
  }
}

template <int NM, int MR>
__device__ __forceinline__ void zero(float (&acc)[NM][MR][4]) {
#pragma unroll
  for (int n = 0; n < NM; ++n)
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][m][c] = 0.0f;
}

__device__ __forceinline__ float e_of(float s, float m) {  // f32(exp(f64(s - m)))
  return static_cast<float>(exp(static_cast<double>(__fsub_rn(s, m))));
}

// four gradients into dqkv + at (16-byte aligned), STE-masked against the
// raw qkv with in_fq
template <bool IN_FQ>
__device__ __forceinline__ void store4(const float* raw, float* dqkv, size_t at, float4 g,
                                       const FqArgs& fq) {
  if (IN_FQ) {
    const float4 x = *reinterpret_cast<const float4*>(raw + at);
    if (!qvt::ste_keep(x.x, fq.s, fq.z, fq.lo, fq.hi)) g.x = 0.0f;
    if (!qvt::ste_keep(x.y, fq.s, fq.z, fq.lo, fq.hi)) g.y = 0.0f;
    if (!qvt::ste_keep(x.z, fq.s, fq.z, fq.lo, fq.hi)) g.z = 0.0f;
    if (!qvt::ste_keep(x.w, fq.s, fq.z, fq.lo, fq.hi)) g.w = 0.0f;
  }
  *reinterpret_cast<float4*>(dqkv + at) = g;
}

template <bool IN_FQ>
__device__ __forceinline__ FqArgs fq_args(const float* qs, float lo, float hi) {
  if (IN_FQ) return FqArgs{qs[0], qs[1], lo, hi};
  return FqArgs{1.0f, 0.0f, lo, hi};
}

template <bool IN_FQ>
__device__ __forceinline__ float fq_value(float v, const FqArgs& fq) {
  return IN_FQ ? qvt::fake_quant(v, fq.s, fq.z, fq.lo, fq.hi) : v;
}

// kernel A: one block per (R queries, head, image)
template <bool IN_FQ, int MR>
__global__ void __launch_bounds__(THREADS, MR == 2 ? 3 : 2)
    attention_f32_fwd_kernel(const float* qkv, const float* qs, float* out, int N, int H, int hd,
                             int n_valid, float scale, float fq_min, float fq_max, int R) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.y, b = blockIdx.z, i0 = blockIdx.x * R, rows = min(R, N - i0);
  const int D = H * hd, ld = op_ld(hd), ns = strip_ld(N), n4 = (N + 3) & ~3;
  float* Qs = reinterpret_cast<float*>(smem);  // [a_rows(R)][ld] q * scale
  float* Ts = Qs + a_rows(R) * ld;              // [2 KT][ld] K, then V
  float* Ss = Ts + 2 * KT * ld;                 // [R][ns] scores, then p
  const FqArgs fq = fq_args<IN_FQ>(qs, fq_min, fq_max);
  const float* img = qkv + (size_t)b * N * 3 * D + h * hd;
  const size_t stride = (size_t)3 * D;
  const auto kv = [&](float v) { return fq_value<IN_FQ>(v, fq); };

  stage(Qs, ld, img + i0 * stride, stride, a_rows(R), rows, hd,
        [&](float v) { return __fmul_rn(fq_value<IN_FQ>(v, fq), scale); });
  const int g = threadIdx.x >> 7;
  for (int k0 = 0; k0 < N; k0 += 2 * KT) {  // sweep 1: the score strip
    const int nk = min(2 * KT, N - k0);
    __syncthreads();
    stage(Ts, ld, img + D + k0 * stride, stride, 2 * KT, nk, hd, kv);
    __syncthreads();
    g1(Qs, Ts + g * KT * ld, ld, hd, rows, nk - g * KT, threadIdx.x & 127,
       [&](int r, int c, float s) {
         const int j = k0 + g * KT + c;
         if (r < rows && j < N) Ss[r * ns + j] = j < n_valid ? s : -1e30f;
       });
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += WARPS) {  // softmax, one warp per row
    float* sr = Ss + r * ns;
    float mx = -1e30f;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, sr[j]);
    mx = qvt::warp_max(mx);
    double l = 0.0;
    for (int j = lane; j < N; j += 32) {
      const float e = e_of(sr[j], mx);
      sr[j] = e;
      l += static_cast<double>(e);
    }
    l = qvt::warp_sum(l);
    for (int j = lane; j < n4; j += 32)
      sr[j] = j < N ? static_cast<float>(static_cast<double>(sr[j]) / l) : 0.0f;
  }
  const G2Map<MR> map(hd, R);
  float acc[1][MR][4];
  zero(acc);
  for (int k0 = 0; k0 < N; k0 += 2 * KT) {  // sweep 2: o = p v
    __syncthreads();
    stage(Ts, ld, img + 2 * D + k0 * stride, stride, 2 * KT, min(2 * KT, N - k0), hd, kv);
    __syncthreads();
    const float* A[1] = {Ss + k0};
    const float* Bm[1] = {Ts};
    if (map.act) g2<1, MR>(A, ns, map, Bm, ld, min(2 * KT, n4 - k0), acc);
  }
  if (!map.act) return;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const int r = map.r(m);
    if (r < rows)
      *reinterpret_cast<float4*>(out + ((size_t)b * N + i0 + r) * D + h * hd + map.d0) =
          make_float4(acc[0][m][0], acc[0][m][1], acc[0][m][2], acc[0][m][3]);
  }
}

// kernel B, launch 1 (rows): one block per (R query rows, head, image)
template <bool IN_FQ, int MR>
__global__ void __launch_bounds__(THREADS, 2)
    attention_f32_bwd_rows_kernel(const float* qkv, const float* dout, const float* qs,
                                  double* stats, float* dqkv, int N, int H, int hd, int n_valid,
                                  float scale, float fq_min, float fq_max, int R) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.y, b = blockIdx.z, i0 = blockIdx.x * R, rows = min(R, N - i0);
  const int D = H * hd, ld = op_ld(hd), ns = strip_ld(N), n4 = (N + 3) & ~3;
  float* Qs = reinterpret_cast<float*>(smem);  // [a_rows(R)][ld] q
  float* Os = Qs + a_rows(R) * ld;              // [a_rows(R)][ld] do
  float* Ks = Os + a_rows(R) * ld;              // [KT][ld] K (sweep 2: [2 KT][ld] with Vs)
  float* Vs = Ks + KT * ld;                     // [KT][ld] V
  float* Ss = Vs + KT * ld;                     // [R][ns] s, then p
  float* Ds = Ss + R * ns;                      // [R][ns] dp, then ds
  const FqArgs fq = fq_args<IN_FQ>(qs, fq_min, fq_max);
  const float* img = qkv + (size_t)b * N * 3 * D + h * hd;
  const size_t stride = (size_t)3 * D;
  const auto kv = [&](float v) { return fq_value<IN_FQ>(v, fq); };

  stage(Qs, ld, img + i0 * stride, stride, a_rows(R), rows, hd, kv);
  stage(Os, ld, dout + ((size_t)b * N + i0) * D + h * hd, D, a_rows(R), rows, hd,
        [](float v) { return v; });
  const int g = threadIdx.x >> 7;
  for (int k0 = 0; k0 < N; k0 += KT) {  // sweep 1: the s and dp strips
    const int nk = min(KT, N - k0);
    __syncthreads();
    stage(Ks, ld, img + D + k0 * stride, stride, KT, nk, hd, kv);
    stage(Vs, ld, img + 2 * D + k0 * stride, stride, KT, nk, hd, kv);
    __syncthreads();
    if (g == 0)
      g1(Qs, Ks, ld, hd, rows, nk, threadIdx.x & 127, [&](int r, int c, float s) {
        const int j = k0 + c;
        if (r < rows && j < N) Ss[r * ns + j] = j < n_valid ? __fmul_rn(s, scale) : -1e30f;
      });
    else
      g1(Os, Vs, ld, hd, rows, nk, threadIdx.x & 127, [&](int r, int c, float dp) {
        if (r < rows && k0 + c < N) Ds[r * ns + k0 + c] = dp;
      });
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bhn = (size_t)gridDim.z * H * N, at0 = ((size_t)b * H + h) * N + i0;
  for (int r = warp; r < rows; r += WARPS) {  // statistics and ds, one warp per row
    float* sr = Ss + r * ns;
    float* dr = Ds + r * ns;
    float mx = -1e30f;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, sr[j]);
    mx = qvt::warp_max(mx);
    double l = 0.0;
    for (int j = lane; j < N; j += 32) {
      const float e = e_of(sr[j], mx);
      sr[j] = e;
      l += static_cast<double>(e);
    }
    l = qvt::warp_sum(l);
    double rs = 0.0;
    for (int j = lane; j < N; j += 32) {
      const float p = static_cast<float>(static_cast<double>(sr[j]) / l);
      sr[j] = p;
      rs += static_cast<double>(__fmul_rn(dr[j], p));
    }
    const float rf = static_cast<float>(qvt::warp_sum(rs));
    for (int j = lane; j < n4; j += 32)
      dr[j] = j < N ? __fmul_rn(sr[j], __fsub_rn(dr[j], rf)) : 0.0f;
    if (lane == 0) {
      stats[at0 + r] = mx;
      stats[bhn + at0 + r] = l;
      stats[2 * bhn + at0 + r] = rf;
    }
  }
  const G2Map<MR> map(hd, R);
  float acc[1][MR][4];
  zero(acc);
  for (int k0 = 0; k0 < N; k0 += 2 * KT) {  // sweep 2: dq = ds k
    __syncthreads();
    stage(Ks, ld, img + D + k0 * stride, stride, 2 * KT, min(2 * KT, N - k0), hd, kv);
    __syncthreads();
    const float* A[1] = {Ds + k0};
    const float* Bm[1] = {Ks};
    if (map.act) g2<1, MR>(A, ns, map, Bm, ld, min(2 * KT, n4 - k0), acc);
  }
  if (!map.act) return;
  const float* raw = qkv + (size_t)b * N * 3 * D;
  float* dimg = dqkv + (size_t)b * N * 3 * D;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const int r = map.r(m);
    if (r < rows)
      store4<IN_FQ>(raw, dimg, (size_t)(i0 + r) * stride + h * hd + map.d0,
                    make_float4(__fmul_rn(acc[0][m][0], scale), __fmul_rn(acc[0][m][1], scale),
                                __fmul_rn(acc[0][m][2], scale), __fmul_rn(acc[0][m][3], scale)),
                    fq);
  }
}

// kernel B, launch 2 (keys): one block per (C_KEYS keys, head, image)
template <bool IN_FQ, int MR>
__global__ void __launch_bounds__(THREADS, MR == 2 ? 3 : 2)
    attention_f32_bwd_keys_kernel(const float* qkv, const float* dout, const float* qs,
                                  const double* stats, float* dqkv, int N, int H, int hd,
                                  int n_valid, float scale, float fq_min, float fq_max) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.y, b = blockIdx.z, j0 = blockIdx.x * C_KEYS;
  const int keys = min(C_KEYS, N - j0);
  const int D = H * hd, ld = op_ld(hd);
  double* Lt = reinterpret_cast<double*>(smem);       // [QT] softmax sums
  float* Mt = reinterpret_cast<float*>(Lt + QT);      // [QT] row max
  float* Rt = Mt + QT;                                 // [QT] rowsum(dp * p)
  float* Kc = Rt + QT;                                 // [C_KEYS][ld] K
  float* Vc = Kc + C_KEYS * ld;                        // [C_KEYS][ld] V
  float* Qt = Vc + C_KEYS * ld;                        // [QT][ld] q
  float* Ot = Qt + QT * ld;                            // [QT][ld] do
  float* St = Ot + QT * ld;                            // [C_KEYS][NQ] s^T, then p^T
  float* Dt = St + C_KEYS * NQ;                        // [C_KEYS][NQ] dp^T, then ds^T
  const FqArgs fq = fq_args<IN_FQ>(qs, fq_min, fq_max);
  const float* img = qkv + (size_t)b * N * 3 * D + h * hd;
  const size_t stride = (size_t)3 * D;
  const auto kv = [&](float v) { return fq_value<IN_FQ>(v, fq); };
  const size_t bhn = (size_t)gridDim.z * H * N, at0 = ((size_t)b * H + h) * N;

  stage(Kc, ld, img + D + j0 * stride, stride, C_KEYS, keys, hd, kv);
  stage(Vc, ld, img + 2 * D + j0 * stride, stride, C_KEYS, keys, hd, kv);
  const G2Map<MR> map(hd, C_KEYS);
  float acc[2][MR][4];  // dk, dv
  zero(acc);
  const int g = threadIdx.x >> 7;
  for (int q0 = 0; q0 < N; q0 += QT) {
    const int nq = min(QT, N - q0);
    __syncthreads();
    stage(Qt, ld, img + q0 * stride, stride, QT, nq, hd, kv);
    stage(Ot, ld, dout + ((size_t)b * N + q0) * D + h * hd, D, QT, nq, hd,
          [](float v) { return v; });
    for (int t = threadIdx.x; t < nq; t += THREADS) {
      Mt[t] = static_cast<float>(stats[at0 + q0 + t]);
      Lt[t] = stats[bhn + at0 + q0 + t];
      Rt[t] = static_cast<float>(stats[2 * bhn + at0 + q0 + t]);
    }
    __syncthreads();
    if (g == 0)
      g1(Kc, Qt, ld, hd, keys, nq, threadIdx.x & 127, [&](int r, int c, float s) {
        St[r * NQ + c] = j0 + r < n_valid ? __fmul_rn(s, scale) : -1e30f;
      });
    else
      g1(Vc, Ot, ld, hd, keys, nq, threadIdx.x & 127,
         [&](int r, int c, float dp) { Dt[r * NQ + c] = dp; });
    __syncthreads();
    for (int t = threadIdx.x; t < C_KEYS * QT; t += THREADS) {  // p^T and ds^T
      const int r = t / QT, c = t % QT;
      float p = 0.0f, ds = 0.0f;
      if (r < keys && c < nq) {
        p = static_cast<float>(static_cast<double>(e_of(St[r * NQ + c], Mt[c])) / Lt[c]);
        ds = __fmul_rn(p, __fsub_rn(Dt[r * NQ + c], Rt[c]));
      }
      St[r * NQ + c] = p;
      Dt[r * NQ + c] = ds;
    }
    __syncthreads();
    const float* A[2] = {Dt, St};
    const float* Bm[2] = {Qt, Ot};
    if (map.act) g2<2, MR>(A, NQ, map, Bm, ld, (nq + 3) & ~3, acc);
  }
  if (!map.act) return;
  const float* raw = qkv + (size_t)b * N * 3 * D;
  float* dimg = dqkv + (size_t)b * N * 3 * D;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const int r = map.r(m);
    if (r >= keys) continue;
    const size_t at = (size_t)(j0 + r) * stride + h * hd + map.d0;
    store4<IN_FQ>(raw, dimg, at + D,
                  make_float4(__fmul_rn(acc[0][m][0], scale), __fmul_rn(acc[0][m][1], scale),
                              __fmul_rn(acc[0][m][2], scale), __fmul_rn(acc[0][m][3], scale)),
                  fq);
    store4<IN_FQ>(raw, dimg, at + 2 * D,
                  make_float4(acc[1][m][0], acc[1][m][1], acc[1][m][2], acc[1][m][3]), fq);
  }
}

// shared-memory plans (bytes); ops/flash_attention.py mirrors them
size_t fwd_smem(int N, int hd, int R) {
  return sizeof(float) * ((size_t)a_rows(R) * op_ld(hd) + (size_t)2 * KT * op_ld(hd) +
                          (size_t)R * strip_ld(N));
}
size_t rows_smem(int N, int hd, int R) {
  return sizeof(float) * ((size_t)2 * a_rows(R) * op_ld(hd) + (size_t)2 * KT * op_ld(hd) +
                          (size_t)2 * R * strip_ld(N));
}
size_t keys_smem(int hd) {
  return (sizeof(double) + 2 * sizeof(float)) * QT +
         sizeof(float) * ((size_t)2 * (C_KEYS + QT) * op_ld(hd) + (size_t)2 * C_KEYS * NQ);
}

// the most rows (32, 16, .., 1) whose plan fits; 0 if none does
int pick_rows(size_t (*plan)(int, int, int), int N, int hd) {
  for (int R = 32; R >= 1; R /= 2)
    if (plan(N, hd, R) <= SMEM_MAX) return R;
  return 0;
}

bool bad_shape(int B, int N, int H, int hd, int n_valid) {
  return B <= 0 || H <= 0 || hd <= 0 || hd > 128 || hd % 8 || N <= 0 || n_valid <= 0 ||
         n_valid > N;
}

// opt the kernel into `smem` bytes of dynamic shared memory
template <typename K>
int allow_smem(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

// kernel A in f32: out [B, N, H*hd] f32; in_fq != 0 fake-quantizes q, k, v
// with (qs[0], qs[1], fq_min, fq_max); scale is hd^-0.5, applied to q before
// the score dot
extern "C" int qvt_attention_fwd(const void* qkv, const void* qs, void* out, int B, int N,
                                 int H, int hd, int n_valid, float scale, int in_fq,
                                 float fq_min, float fq_max, void* stream) {
  if (bad_shape(B, N, H, hd, n_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const int R = pick_rows(fwd_smem, N, hd);
  if (!R) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem(N, hd, R);
  auto kernel = in_fq ? (hd <= 64 ? attention_f32_fwd_kernel<true, 2>
                                  : attention_f32_fwd_kernel<true, 4>)
                      : (hd <= 64 ? attention_f32_fwd_kernel<false, 2>
                                  : attention_f32_fwd_kernel<false, 4>);
  const int e = allow_smem(kernel, smem);
  if (e) return e;
  kernel<<<dim3((N + R - 1) / R, H, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(qs), static_cast<float*>(out), N,
      H, hd, n_valid, scale, fq_min, fq_max, R);
  return static_cast<int>(cudaGetLastError());
}

// kernel B in f32, launch 1: the row statistics of the softmax into stats
// [3, B, H, N] f64 (max, sum, rowsum(dp * p)) and dq into the packed dqkv
// [B, N, 3*H*hd]; scale is the f32 hd^-0.5 applied after the dots
extern "C" int qvt_attention_bwd_rows(const void* qkv, const void* dout, const void* qs,
                                      void* stats, void* dqkv, int B, int N, int H, int hd,
                                      int n_valid, float scale, int in_fq, float fq_min,
                                      float fq_max, void* stream) {
  if (bad_shape(B, N, H, hd, n_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const int R = pick_rows(rows_smem, N, hd);
  if (!R) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = rows_smem(N, hd, R);
  auto kernel = in_fq ? (hd <= 64 ? attention_f32_bwd_rows_kernel<true, 2>
                                  : attention_f32_bwd_rows_kernel<true, 4>)
                      : (hd <= 64 ? attention_f32_bwd_rows_kernel<false, 2>
                                  : attention_f32_bwd_rows_kernel<false, 4>);
  const int e = allow_smem(kernel, smem);
  if (e) return e;
  kernel<<<dim3((N + R - 1) / R, H, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout),
      static_cast<const float*>(qs), static_cast<double*>(stats), static_cast<float*>(dqkv), N,
      H, hd, n_valid, scale, fq_min, fq_max, R);
  return static_cast<int>(cudaGetLastError());
}

// kernel B in f32, launch 2: dk and dv into dqkv from the rows pass's stats
extern "C" int qvt_attention_bwd_keys(const void* qkv, const void* dout, const void* qs,
                                      void* stats, void* dqkv, int B, int N, int H, int hd,
                                      int n_valid, float scale, int in_fq, float fq_min,
                                      float fq_max, void* stream) {
  if (bad_shape(B, N, H, hd, n_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = keys_smem(hd);
  auto kernel = in_fq ? (hd <= 64 ? attention_f32_bwd_keys_kernel<true, 2>
                                  : attention_f32_bwd_keys_kernel<true, 4>)
                      : (hd <= 64 ? attention_f32_bwd_keys_kernel<false, 2>
                                  : attention_f32_bwd_keys_kernel<false, 4>);
  const int e = allow_smem(kernel, smem);
  if (e) return e;
  kernel<<<dim3((N + C_KEYS - 1) / C_KEYS, H, B), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout),
      static_cast<const float*>(qs), static_cast<const double*>(stats),
      static_cast<float*>(dqkv), N, H, hd, n_valid, scale, fq_min, fq_max);
  return static_cast<int>(cudaGetLastError());
}
