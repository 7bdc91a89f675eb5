// Backward of multi-head attention over the packed bf16 qkv on the tensor
// cores, for sm_90a (kernel B, K1's backward, in bf16): two deterministic
// launches, no atomics.
//
// Replaces (TPU, Pallas): qat_vit_tpu/ops/flash_attention_train.py::
// _attention_bwd_kernel (launched by _attention_bwd_call), with and without
// in_fq, for a bf16 qkv: the VJP of attention_train and attention_train_fq.
// The f32 form stays on the CUDA cores (csrc/attention_bwd.cu).
//
// Math, per (image, head), as the TPU kernel. The forward saves only the
// raw qkv (the custom-VJP contract), so this kernel recomputes the softmax
// statistics itself. q, k, v are the raw qkv or, with in_fq, its
// fake-quantized values (f32, round half to even, clip, back to bf16;
// scale and zero point from the device pointer qs);
//   s  = (q k^T) * scale           f32 dot, scaled AFTER it in f32, q
//                                  unscaled (the forward scales q in bf16);
//   keys >= n_valid at -1e30;  p = softmax(s) in f32;  dp = do v^T;
//   ds = bf16(p * (dp - rowsum(dp * p)));  p16 = bf16(p);
//   dq = (ds k) * scale,  dk = (ds^T q) * scale,  dv = p16^T do,
// every product on mma.sync.m16n8k16 (bf16 in, f32 accumulate), each result
// rounded to bf16 once into the packed dqkv [B, N, 3*H*hd]. rowsum(dp * p)
// is the TPU kernel's, not K5b's rowsum(do * o): there is no o. With in_fq
// the straight-through estimator's mask, recomputed from the raw qkv
// (qmin <= rint(raw / s + zp) <= qmax), zeroes dq, dk and dv before the
// store, as the plain version's.
//
// What bounds it on an H100. The VJP is 10*N*N*hd operations per (image,
// head) (s, dp, dq, dk, dv) on 14*N*hd bytes (qkv and do read, dqkv
// written): at ViT-S's 197 tokens ~140 operations per byte, under the
// card's ~295 in bf16, so the bound is the bytes; only the tensor cores
// keep the operations near it (989 TFLOP/s in bf16 against 67 for f32 on
// the CUDA cores, where csrc/attention_bwd.cu runs). The two passes below
// recompute s and dp twice more (18*N*N*hd in all), the price of having no
// atomics: the TPU kernel sums dk and dv over one resident [N, N] tile,
// while blocks here run in no order, and atomic sums change from run to
// run.
//
// Design: K5b's two passes (attention_long_bwd_mma.cu), with the
// statistics taken in the rows pass instead of read from the forward.
// 1. rows (dq and the row statistics): one block per (128 query rows, head,
//    image), 8 warps of 16 rows; the block's q (fake-quantized) and do rows
//    in shared memory. K and V of the head resident where they fit (~60 KB
//    at 197 x 64, rows of hd + 8 bf16 for conflict-free ldmatrix, zero-filled
//    past N), copied once by cp.async; elsewhere (N past ~680 at hd 64, ~300
//    at hd 128) both sweeps stream 32-key tiles through K6a's cp.async ring
//    (3 stages at hd <= 64, 2 above).
//    Sweep 1, per 32-key tile: S = q K^T and dP = do V^T on mma; the
//    running max m, sum l of exp2((s - m) log2e) and R of exp2(..) * dp,
//    both rescaled as m grows (K5a's online form). Then per row
//    lse2 = m log2e + log2(l) and rowsum = R / l, written to an f32
//    [2, B, H, N] scratch for pass 2.
//    Sweep 2, per tile: S and dP again, p = exp2(s log2e - lse2), dS =
//    bf16(p (dP - rowsum)) in registers, fed as the A operand of dQ += dS K
//    (K's fragments through ldmatrix.trans). dq = dQ * scale in f32.
// 2. keys (dk, dv): one block per (128 keys, head, image), 8 warps of 16
//    keys, its K and V rows resident (fake-quantized); it streams q
//    (fake-quantized as it lands), do and the statistics over all N query
//    rows, 32 at a time, through the same stages; recomputes S^T, P^T,
//    dP^T and dS^T the same way, 16 queries at a time, and adds
//    dV += bf16(P^T) do and dK += dS^T q in f32 registers.
// Both passes keep to 128 registers a thread at hd <= 64 (two blocks of
// 256 threads per SM; the streamed rows pass, off ViT's path, takes more). hd is any multiple of 8 up to 128 (the dots
// zero-filled to a multiple of 16); any N >= 1.
//
// Roundings kept from the TPU kernel: the fake-quant; s scaled after its
// f32 dot; p and ds rounded to bf16 for their products; dq and dk scaled in
// f32 after their dots, dk with the unscaled q; f32 accumulators; masking
// at -1e30. Against the plain version (ops/flash_attention_train.
// attention_bwd_plain: index-order f32 sums, exp and the softmax sums in
// f64) the sums run in the tensor cores' order, the statistics online in
// f32 and ex2.approx replaces the f64 exp, so dq, dk and dv are held to
// rel L2 1e-2 of the plain version and to twice its distance from the f64
// math, two launches identical, the STE zero set identical
// (chip_smoke.py, tests/test_torch_port_cuda.py).

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

using namespace qvt_mma;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // rows pass: query rows per block; keys pass: keys per block
constexpr int BN = 32;          // rows pass: keys per tile
constexpr int QT = 32;          // keys pass: query rows per tile
// H100: the dynamic shared memory one block may opt into (bytes)
constexpr size_t SMEM_MAX = 232448;

template <int HDP>
constexpr int SROW = HDP + 8;  // a tile row: an odd number of 16-byte chunks

// blocks per SM that the register budget must allow: 512 threads (<= 128
// registers each) at hd <= 64 (the rows pass: where K and V are resident);
// above, the compiler's choice
template <int HDP, bool RESIDENT = true>
constexpr int MIN_BLOCKS = HDP <= 64 && RESIDENT ? 512 / THREADS : 1;

template <int HDP>
constexpr int STAGES = HDP <= 64 ? 3 : 2;

// rows of the resident K and V: N rounded up to 16 (zero-filled past N)
__host__ __device__ inline int resident_rows(int n) { return (n + 15) & ~15; }

template <int HDP>
size_t rows_resident_smem(int n) {  // q, do; K, V of the head
  return sizeof(bf16) * (size_t)SROW<HDP> * (2 * BM + 2 * resident_rows(n));
}

template <int HDP>
constexpr size_t rows_stream_smem() {  // q, do; K and V per stage
  return sizeof(bf16) * (size_t)SROW<HDP> * (2 * BM + 2 * STAGES<HDP> * BN);
}

template <int HDP>
constexpr size_t keys_smem() {  // K, V; per stage q, do, lse2 and rowsum of QT rows
  return sizeof(bf16) * (size_t)SROW<HDP> * (2 * BM + 2 * STAGES<HDP> * QT) +
         sizeof(float) * 2 * STAGES<HDP> * QT;
}

// S = q K^T and dP = do V^T for the warp's 16 rows (Qw, Gw: their staged
// rows) against the BN keys of (Kt, Vt); key groups of 16 from ng on are
// skipped (they stay 0)
template <int HDP>
__device__ __forceinline__ void s_dp(const bf16* Qw, const bf16* Gw, const bf16* Kt,
                                     const bf16* Vt, int hdp, int ng, float (&s)[BN / 8][4],
                                     float (&dp)[BN / 8][4]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) {
    if (16 * ks >= hdp) continue;
    uint32_t qa[4], ga[4];
    frag_a<HDP>(Qw, ks, qa);
    frag_a<HDP>(Gw, ks, ga);
#pragma unroll
    for (int np = 0; np < BN / 16; ++np) {
      if (np >= ng) continue;
      uint32_t kb[4], vb[4];
      frag_b<HDP>(Kt, 16 * np, ks, kb);
      mma(s[2 * np], qa, kb[0], kb[1]);
      mma(s[2 * np + 1], qa, kb[2], kb[3]);
      frag_b<HDP>(Vt, 16 * np, ks, vb);
      mma(dp[2 * np], ga, vb[0], vb[1]);
      mma(dp[2 * np + 1], ga, vb[2], vb[3]);
    }
  }
}

// two adjacent 8-column C fragments, packed to bf16: the A fragment of their
// 16 columns
__device__ __forceinline__ void pack_a(const float (&c0)[4], const float (&c1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// two gradient values at columns (c, c + 1) of `row` in dqkv, STE-masked
// with the raw qkv at the same place (`raw`), rounded to bf16
template <bool IN_FQ>
__device__ __forceinline__ void store2(bf16* row, const bf16* raw, int c, float v0, float v1,
                                       float fs, float fz, float fq_min, float fq_max) {
  if constexpr (IN_FQ) {
    const float2 x = unpack_bf16(*reinterpret_cast<const uint32_t*>(raw + c));
    if (!qvt::ste_keep(x.x, fs, fz, fq_min, fq_max)) v0 = 0.0f;
    if (!qvt::ste_keep(x.y, fs, fz, fq_min, fq_max)) v1 = 0.0f;
  }
  *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(v0, v1);
}

template <int HDP, bool IN_FQ, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, (MIN_BLOCKS<HDP, RESIDENT>))
    attention_bwd_rows_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                                  const float* __restrict__ qs, float* __restrict__ lse2,
                                  float* __restrict__ rsum, bf16* __restrict__ dqkv, int N, int H,
                                  int hd, int n_valid, float scale, float fq_min, float fq_max) {
  constexpr int S = SROW<HDP>;
  constexpr int KS = HDP / 16;
  constexpr int NS = STAGES<HDP>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd;
  const size_t ld = 3 * (size_t)D;
  const bf16* const img = qkv + (size_t)b * N * ld + h * hd;
  const bf16* const gimg = dout + (size_t)b * N * D + h * hd;
  const int hdp = (hd + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = (N + BN - 1) / BN;  // key tiles per sweep
  const int total = 2 * nt;          // sweep w: tiles w nt .. (w + 1) nt - 1
  const int R = RESIDENT ? resident_rows(N) : 0;

  float fs = 1.0f, fz = 0.0f;
  if constexpr (IN_FQ) {
    fs = qs[0];
    fz = qs[1];
  }
  const auto fq = [=](float x) { return qvt::fake_quant(x, fs, fz, fq_min, fq_max); };

  // q [BM][S], do [BM][S]; resident: K [R][S], V [R][S]; streaming: K and V
  // [NS][BN][S] each
  bf16* const Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* const Gs = Qs + BM * S;
  bf16* const Ks = Gs + BM * S;
  bf16* const Vs = Ks + (RESIDENT ? R : NS * BN) * S;

  const auto load = [&](int t, int stage) {  // key tile t % nt into ring stage `stage`
    const int k0 = (t % nt) * BN;
    stage_rows<HDP, THREADS>(Ks + stage * BN * S, img + D, ld, k0, BN, N, hd);
    stage_rows<HDP, THREADS>(Vs + stage * BN * S, img + 2 * D, ld, k0, BN, N, hd);
    cp_async_commit();
  };

  stage_rows<HDP, THREADS>(Qs, img, ld, q0, BM, N, hd);
  stage_rows<HDP, THREADS>(Gs, gimg, D, q0, BM, N, hd);
  if constexpr (RESIDENT) {
    stage_rows<HDP, THREADS>(Ks, img + D, ld, 0, R, N, hd);
    stage_rows<HDP, THREADS>(Vs, img + 2 * D, ld, 0, R, N, hd);
  }
  cp_async_commit();
  if constexpr (RESIDENT) {
    cp_async_wait<0>();
    if constexpr (IN_FQ) {
      map_rows<HDP, THREADS>(Ks, 0, R, N, hd, fq);
      map_rows<HDP, THREADS>(Vs, 0, R, N, hd, fq);
    }
  } else {
    for (int t = 0; t < NS - 1; ++t) {  // the first tiles (empty groups past the last)
      if (t < total)
        load(t, t);
      else
        cp_async_commit();
    }
    cp_async_wait<NS - 1>();  // the q and do rows have landed
  }
  if constexpr (IN_FQ) map_rows<HDP, THREADS>(Qs, q0, BM, N, hd, fq);
  __syncthreads();

  // the K and V tiles of step t: resident, or ring stage t % NS once landed
  const auto tiles = [&](int t, const bf16*& Kt, const bf16*& Vt) {
    if constexpr (RESIDENT) {
      const int k0 = (t % nt) * BN;
      Kt = Ks + k0 * S;
      Vt = Vs + k0 * S;
    } else {
      const int stage = t % NS, next = t + NS - 1;
      cp_async_wait<NS - 2>();
      if constexpr (IN_FQ) {
        const int k0 = (t % nt) * BN;
        map_rows<HDP, THREADS>(Ks + stage * BN * S, k0, BN, N, hd, fq);
        map_rows<HDP, THREADS>(Vs + stage * BN * S, k0, BN, N, hd, fq);
      }
      __syncthreads();  // tile t visible to every warp, and every warp done with tile t - 1
      if (next < total)  // into tile t - 1's stage
        load(next, next % NS);
      else
        cp_async_commit();
      Kt = Ks + stage * BN * S;
      Vt = Vs + stage * BN * S;
    }
  };
  // s scaled after its dot, keys >= n_valid (and >= N) at -1e30
  const auto scale_mask = [&](int k0, float (&s)[BN / 8][4]) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = k0 + 8 * j + 2 * (lane & 3) + (e & 1) < n_valid ? __fmul_rn(s[j][e], scale)
                                                                  : -1e30f;
  };
  const bf16* const Qw = Qs + warp * 16 * S;
  const bf16* const Gw = Gs + warp * 16 * S;

  // ---- sweep 1: per row (g, g + 8) the running max, sum and sum of e * dp ----
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f}, r[2] = {0.0f, 0.0f};
  for (int t = 0; t < nt; ++t) {
    const bf16 *Kt, *Vt;
    tiles(t, Kt, Vt);
    const int k0 = t * BN, ng = min(BN, N - k0 + 15) / 16;
    float s[BN / 8][4], dp[BN / 8][4];
    s_dp<HDP>(Qw, Gw, Kt, Vt, hdp, ng, s, dp);
    scale_mask(k0, s);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float ml[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = ex2((m[i] - mx[i]) * LOG2E);
      l[i] *= alpha;
      r[i] *= alpha;
      m[i] = mx[i];
      ml[i] = mx[i] * LOG2E;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ev = ex2(fmaf(s[j][e], LOG2E, -ml[e >> 1]));
        l[e >> 1] += ev;
        r[e >> 1] = fmaf(ev, dp[j][e], r[e >> 1]);
      }
  }
  const int g = lane >> 2;
  float lr[2], dr[2];  // lse2 and rowsum(dp * p) of rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
      r[i] += __shfl_xor_sync(0xffffffffu, r[i], off);
    }
    lr[i] = fmaf(m[i], LOG2E, log2f(l[i]));
    dr[i] = r[i] / l[i];
    const int qi = q0 + warp * 16 + g + 8 * i;
    if ((lane & 3) == 0 && qi < N) {
      lse2[((size_t)b * H + h) * N + qi] = lr[i];
      rsum[((size_t)b * H + h) * N + qi] = dr[i];
    }
  }

  // ---- sweep 2: dQ += bf16(p (dP - rowsum)) K ----
  float dq[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;
  for (int t = nt; t < total; ++t) {
    const bf16 *Kt, *Vt;
    tiles(t, Kt, Vt);
    const int k0 = (t - nt) * BN, ng = min(BN, N - k0 + 15) / 16;
    float s[BN / 8][4], dp[BN / 8][4];
    s_dp<HDP>(Qw, Gw, Kt, Vt, hdp, ng, s, dp);
    scale_mask(k0, s);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[j][e], LOG2E, -lr[e >> 1]));
        s[j][e] = p * (dp[j][e] - dr[e >> 1]);
      }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      if (kk >= ng) continue;
      uint32_t da[4];
      pack_a(s[2 * kk], s[2 * kk + 1], da);
#pragma unroll
      for (int dpair = 0; dpair < KS; ++dpair) {
        if (16 * dpair >= hdp) continue;
        uint32_t kb[4];
        frag_bt<HDP>(Kt, 16 * kk, dpair, kb);
        mma(dq[2 * dpair], da, kb[0], kb[1]);
        mma(dq[2 * dpair + 1], da, kb[2], kb[3]);
      }
    }
  }
  if constexpr (!RESIDENT) cp_async_wait<0>();

  // ---- dq = dQ * scale, STE-masked, into the packed dqkv ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + warp * 16 + g + 8 * i;
    if (qi >= N) continue;
    const size_t at = ((size_t)b * N + qi) * ld + h * hd;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      if (c < hd)
        store2<IN_FQ>(dqkv + at, qkv + at, c, __fmul_rn(dq[j][2 * i], scale),
                      __fmul_rn(dq[j][2 * i + 1], scale), fs, fz, fq_min, fq_max);
    }
  }
}

template <int HDP, bool IN_FQ>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<HDP>)
    attention_bwd_keys_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                                  const float* __restrict__ qs, const float* __restrict__ lse2,
                                  const float* __restrict__ rsum, bf16* __restrict__ dqkv, int N,
                                  int H, int hd, int n_valid, float scale, float fq_min,
                                  float fq_max) {
  constexpr int S = SROW<HDP>;
  constexpr int KS = HDP / 16;
  constexpr int NS = STAGES<HDP>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* const Ks = reinterpret_cast<bf16*>(smem_raw);  // [BM][S]
  bf16* const Vs = Ks + BM * S;                         // [BM][S]
  bf16* const Qt = Vs + BM * S;                         // [NS][QT][S] q
  bf16* const Gt = Qt + NS * QT * S;                    // [NS][QT][S] do
  float* const Lt = reinterpret_cast<float*>(Gt + NS * QT * S);  // [NS][QT] lse2
  float* const Rt = Lt + NS * QT;                                // [NS][QT] rowsum
  const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd;
  const size_t ld = 3 * (size_t)D;
  const bf16* const img = qkv + (size_t)b * N * ld + h * hd;
  const bf16* const gimg = dout + (size_t)b * N * D + h * hd;
  const float* const lrow = lse2 + ((size_t)b * H + h) * N;
  const float* const rrow = rsum + ((size_t)b * H + h) * N;
  const int hdp = (hd + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (N + QT - 1) / QT;  // query tiles

  float fs = 1.0f, fz = 0.0f;
  if constexpr (IN_FQ) {
    fs = qs[0];
    fz = qs[1];
  }
  const auto fq = [=](float x) { return qvt::fake_quant(x, fs, fz, fq_min, fq_max); };

  stage_rows<HDP, THREADS>(Ks, img + D, ld, k0, BM, N, hd);
  stage_rows<HDP, THREADS>(Vs, img + 2 * D, ld, k0, BM, N, hd);
  const auto load = [&](int u, int stage) {  // query tile u into ring stage `stage`
    stage_rows<HDP, THREADS>(Qt + stage * QT * S, img, ld, u * QT, QT, N, hd);
    stage_rows<HDP, THREADS>(Gt + stage * QT * S, gimg, D, u * QT, QT, N, hd);
    for (int i = threadIdx.x; i < QT; i += THREADS) {
      const int qi = u * QT + i;
      cp_async4_zfill(Lt + stage * QT + i, qi < N ? lrow + qi : lrow, qi < N);
      cp_async4_zfill(Rt + stage * QT + i, qi < N ? rrow + qi : rrow, qi < N);
    }
    cp_async_commit();
  };
  for (int u = 0; u < NS - 1; ++u) {  // the first, with K and V in one commit group
    if (u < nq)
      load(u, u);
    else
      cp_async_commit();
  }

  float dk[2 * KS][4], dv[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  const bf16* const Kw = Ks + warp * 16 * S;
  const bf16* const Vw = Vs + warp * 16 * S;
  const int g = lane >> 2;
  const bool key_ok[2] = {k0 + warp * 16 + g < n_valid, k0 + warp * 16 + g + 8 < n_valid};

  for (int u = 0; u < nq; ++u) {
    const int stage = u % NS, next = u + NS - 1;
    cp_async_wait<NS - 2>();
    if constexpr (IN_FQ) {
      if (u == 0) {  // K and V landed with the first tile
        map_rows<HDP, THREADS>(Ks, k0, BM, N, hd, fq);
        map_rows<HDP, THREADS>(Vs, k0, BM, N, hd, fq);
      }
      map_rows<HDP, THREADS>(Qt + stage * QT * S, u * QT, QT, N, hd, fq);
    }
    __syncthreads();  // tile u visible to every thread, and every warp done with tile u - 1
    if (next < nq)  // into tile u - 1's stage
      load(next, next % NS);
    else
      cp_async_commit();
    const bf16* const Qu = Qt + stage * QT * S;
    const bf16* const Gu = Gt + stage * QT * S;
    const float* const Lu = Lt + stage * QT;
    const float* const Ru = Rt + stage * QT;

    // per 16 queries: S^T = K q^T and dP^T = V do^T (16 keys x 16 queries
    // per warp); P^T = exp2(s log2e - lse2), dS^T = P^T (dP^T - rowsum),
    // masked keys and padded queries 0; dV += bf16(P^T) do, dK += bf16(dS^T) q
#pragma unroll
    for (int np = 0; np < QT / 16; ++np) {
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (16 * ks >= hdp) continue;
        uint32_t ka[4], va[4], qb[4], gb[4];
        frag_a<HDP>(Kw, ks, ka);
        frag_a<HDP>(Vw, ks, va);
        frag_b<HDP>(Qu, 16 * np, ks, qb);
        mma(st[0], ka, qb[0], qb[1]);
        mma(st[1], ka, qb[2], qb[3]);
        frag_b<HDP>(Gu, 16 * np, ks, gb);
        mma(dpt[0], va, gb[0], gb[1]);
        mma(dpt[1], va, gb[2], gb[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 16 * np + 8 * j + 2 * (lane & 3) + (e & 1);
          const float p = (key_ok[e >> 1] && u * QT + c < N)
                              ? ex2(fmaf(__fmul_rn(st[j][e], scale), LOG2E, -Lu[c]))
                              : 0.0f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - Ru[c]);
        }
      uint32_t pa[4], da[4];
      pack_a(st[0], st[1], pa);
      pack_a(dpt[0], dpt[1], da);
#pragma unroll
      for (int dpair = 0; dpair < KS; ++dpair) {
        if (16 * dpair >= hdp) continue;
        uint32_t gb[4], qb[4];
        frag_bt<HDP>(Gu, 16 * np, dpair, gb);
        mma(dv[2 * dpair], pa, gb[0], gb[1]);
        mma(dv[2 * dpair + 1], pa, gb[2], gb[3]);
        frag_bt<HDP>(Qu, 16 * np, dpair, qb);
        mma(dk[2 * dpair], da, qb[0], qb[1]);
        mma(dk[2 * dpair + 1], da, qb[2], qb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // ---- dk = dK * scale and dv, STE-masked, into the packed dqkv ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + warp * 16 + g + 8 * i;
    if (kj >= N) continue;
    const size_t at = ((size_t)b * N + kj) * ld + h * hd;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      if (c < hd) {
        store2<IN_FQ>(dqkv + at + D, qkv + at + D, c, __fmul_rn(dk[j][2 * i], scale),
                      __fmul_rn(dk[j][2 * i + 1], scale), fs, fz, fq_min, fq_max);
        store2<IN_FQ>(dqkv + at + 2 * D, qkv + at + 2 * D, c, dv[j][2 * i], dv[j][2 * i + 1], fs,
                      fz, fq_min, fq_max);
      }
    }
  }
}

template <int HDP, bool IN_FQ, bool RESIDENT>
int rows(size_t smem, const bf16* qkv, const bf16* dout, const float* qs, float* lse2,
         float* rsum, bf16* dqkv, int B, int N, int H, int hd, int n_valid, float scale,
         float fq_min, float fq_max, cudaStream_t st) {
  auto kernel = attention_bwd_rows_mma_kernel<HDP, IN_FQ, RESIDENT>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((N + BM - 1) / BM, H, B), THREADS, smem, st>>>(
      qkv, dout, qs, lse2, rsum, dqkv, N, H, hd, n_valid, scale, fq_min, fq_max);
  return static_cast<int>(cudaGetLastError());
}

// the rows pass (K and V resident where one head's fit, else streamed),
// then the keys pass, on `st`
template <int HDP, bool IN_FQ>
int launch(const bf16* qkv, const bf16* dout, const float* qs, float* stats, bf16* dqkv, int B,
           int N, int H, int hd, int n_valid, float scale, float fq_min, float fq_max,
           cudaStream_t st) {
  float* const lse2 = stats;
  float* const rsum = stats + (size_t)B * H * N;
  const size_t resident = rows_resident_smem<HDP>(N);
  int err = resident <= SMEM_MAX
                ? rows<HDP, IN_FQ, true>(resident, qkv, dout, qs, lse2, rsum, dqkv, B, N, H, hd,
                                         n_valid, scale, fq_min, fq_max, st)
                : rows<HDP, IN_FQ, false>(rows_stream_smem<HDP>(), qkv, dout, qs, lse2, rsum,
                                          dqkv, B, N, H, hd, n_valid, scale, fq_min, fq_max, st);
  if (err) return err;
  auto keys = attention_bwd_keys_mma_kernel<HDP, IN_FQ>;
  const size_t ks = keys_smem<HDP>();
  const cudaError_t e = cudaFuncSetAttribute(keys, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(ks));
  if (e != cudaSuccess) return static_cast<int>(e);
  keys<<<dim3((N + BM - 1) / BM, H, B), THREADS, ks, st>>>(
      qkv, dout, qs, lse2, rsum, dqkv, N, H, hd, n_valid, scale, fq_min, fq_max);
  return static_cast<int>(cudaGetLastError());
}

template <bool IN_FQ>
int dispatch(const void* qkv, const void* dout, const void* qs, void* stats, void* dqkv, int B,
             int N, int H, int hd, int n_valid, float scale, float fq_min, float fq_max,
             void* stream) {
  if (hd <= 0 || hd > 128 || hd % 8 || N <= 0 || n_valid <= 0 || n_valid > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const bf16*>(qkv);
  const auto* g = static_cast<const bf16*>(dout);
  const auto* s = static_cast<const float*>(qs);
  auto* st = static_cast<float*>(stats);
  auto* out = static_cast<bf16*>(dqkv);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch<64, IN_FQ>(q, g, s, st, out, B, N, H, hd, n_valid, scale, fq_min, fq_max, cs);
  return launch<128, IN_FQ>(q, g, s, st, out, B, N, H, hd, n_valid, scale, fq_min, fq_max, cs);
}

}  // namespace

// dqkv [B, N, 3*H*hd] bf16 from the raw bf16 qkv [B, N, 3*H*hd] and do
// [B, N, H*hd]; in_fq != 0 fake-quantizes q, k, v with (qs[0], qs[1],
// fq_min, fq_max) and applies the STE mask; scale: hd^-0.5 in f32; stats:
// f32 [2, B, H, N] scratch from the rows pass to the keys pass. Two launches
// on `stream`.
extern "C" int qvt_attention_bwd_mma(const void* qkv, const void* dout, const void* qs,
                                     void* stats, void* dqkv, int B, int N, int H, int hd,
                                     int n_valid, float scale, int in_fq, float fq_min,
                                     float fq_max, void* stream) {
  if (in_fq)
    return dispatch<true>(qkv, dout, qs, stats, dqkv, B, N, H, hd, n_valid, scale, fq_min, fq_max,
                          stream);
  return dispatch<false>(qkv, dout, nullptr, stats, dqkv, B, N, H, hd, n_valid, scale, 0.0f, 0.0f,
                         stream);
}
