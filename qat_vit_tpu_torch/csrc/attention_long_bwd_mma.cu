// Backward of the long-sequence attention over the packed bf16 qkv on the
// tensor cores, for sm_90a (K5b in bf16, the VJP of
// qvt_attention_long_mma): two deterministic passes, no atomics.
//
// Replaces (TPU, Pallas): qat_vit_tpu/ops/long_attention.py::
// _long_attention_bwd_kernel (launched by _long_attention_bwd_call), for a
// bf16 qkv. The f32 form stays on csrc/attention_long_bwd.cu.
//
// Math, per (image, head), FlashAttention-2's backward with the forward's
// statistics: with qs = bf16(q * scale) (the q scaling in bf16 before the
// dot, as the forward), lse the forward's log-sum-exp of each row and o its
// bf16 output,
//   s = qs k^T (keys >= n_valid masked);  p = exp(s - lse);
//   D = rowsum(do * o) in f32;  dp = do v^T;  ds = bf16(p * (dp - D));
//   dq = (ds k) * scale,  dk = (ds^T q) * scale (q unscaled),
//   dv = bf16(p)^T do,
// every product on mma.sync.m16n8k16 (bf16 in, f32 accumulate), each
// result rounded to bf16 once into the packed dqkv [B, N, 3*H*hd]. Query
// rows >= n_valid are padding: their cotangent is zero, so their dq rows are
// zero and they add nothing to dk and dv; keys >= n_valid get p = 0, so
// their dk and dv rows are zero.
//
// What bounds it on an H100. The VJP is 10*N*N*hd operations per (image,
// head) (s, dp, dq, dk, dv) on ~7*N*hd*2 bytes: compute-bound, like the
// forward. The two passes recompute s and dp once more (14*N*N*hd), the
// price of having no atomics: the TPU kernel carries dk and dv across a
// sequential grid dimension, while blocks here run in no order, and atomic
// sums would change from run to run.
//
// Design. Two launches; each block sums in a fixed order, so two calls on
// the same inputs give identical bits.
// 1. rows (dq): one block per (128 query rows, head, image), 8 warps of 16
//    rows. It takes D for its rows (each warp, its 16 rows in turn), stages
//    its scaled q rows and its do rows in shared memory, writes D and the
//    scaled q rows out for pass 2, then streams K and V in tiles of 64 keys
//    through three cp.async stages (two at hd > 64): per tile S and dP on
//    mma, P = exp2(S log2e - lse log2e), dS rounded to bf16 in registers
//    and fed as the A operand of dQ += dS K (K's fragments through
//    ldmatrix.trans). dq = dQ * scale in f32, rounded to bf16 once.
// 2. keys (dk, dv): one block per (128 keys, head, image), 8 warps of 16
//    keys; its K and V rows stay resident. It streams q, the scaled q of
//    pass 1, do, lse and D over the queries < n_valid, QT = 32 rows at a
//    time through the same stages, recomputes S^T = K qs^T, P^T, dP^T =
//    V do^T and dS^T the same way, and adds dV += bf16(P^T) do and dK +=
//    dS^T q in f32 registers; dk = dK * scale and dv are written once.
//
// Both passes keep to 128 registers a thread at hd <= 64 (two blocks of 256
// threads per SM).
//
// Roundings kept from the TPU kernel: q scaled in bf16 before the score
// dot; p rounded to bf16 for dv and ds to bf16; dq and dk scaled in f32
// after their dots, dk with the unscaled q; f32 accumulators; masking. Given
// up: index-ordered sums, the f64 exp and sums of the plain version
// (ops/long_attention.long_attention_bwd_plain), and rowsum(dp * p), which
// is taken here as rowsum(do * o) from the forward's rounded output.

#include "mma_tile.cuh"

namespace {

using namespace qvt_mma;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // pass 1: query rows per block; pass 2: keys per block
constexpr int BN = 64;          // pass 1: keys per tile

constexpr int QT = 32;          // pass 2: query rows per tile

// blocks per SM that the register budget must allow: 512 threads (<= 128
// registers each) at hd <= 64; above, the compiler's choice
template <int HDP>
constexpr int MIN_BLOCKS = HDP <= 64 ? 512 / THREADS : 1;

// cp.async stages of the streamed tiles: three at hd <= 64, two above
template <int HDP>
constexpr int STAGES = HDP <= 64 ? 3 : 2;

template <int HDP>
constexpr size_t rows_smem() {
  return sizeof(bf16) * (size_t)(2 * BM + 2 * STAGES<HDP> * BN) * (HDP + 8);  // qs, do, K, V
}

template <int HDP>
constexpr size_t keys_smem() {
  // K, V; per stage q, qs, do, lse and D of QT rows
  return sizeof(bf16) * (size_t)(2 * BM + 3 * STAGES<HDP> * QT) * (HDP + 8) +
         sizeof(float) * 2 * STAGES<HDP> * QT;
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<HDP>)
    long_bwd_rows_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ out,
                             const bf16* __restrict__ dout, const float* __restrict__ lse,
                             float* __restrict__ dsum, bf16* __restrict__ qsc,
                             bf16* __restrict__ dqkv, int N, int H, int hd, int n_valid,
                             float qscale, float scale) {
  constexpr int SROW = HDP + 8;
  constexpr int KS = HDP / 16;
  constexpr int NS = STAGES<HDP>;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* const Qs = reinterpret_cast<bf16*>(smem);    // [BM][SROW] scaled q
  bf16* const Gs = Qs + BM * SROW;                   // [BM][SROW] do
  bf16* const Ks = Gs + BM * SROW;                   // [NS][BN][SROW]
  bf16* const Vs = Ks + NS * BN * SROW;              // [NS][BN][SROW]
  __shared__ float rowD[BM], rowL[BM];
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd;
  const size_t ld = 3 * (size_t)D;
  const bf16* const img = qkv + (size_t)b * N * ld + h * hd;
  const bf16* const gimg = dout + (size_t)b * N * D + h * hd;
  const int hdp = (hd + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (N + BN - 1) / BN;

  load_tile<BM, HDP, THREADS>(Gs, gimg, D, q0, n_valid, hd);  // do of padded rows: 0
  cp_async_commit();
  auto load_kv = [&](int t, int stage) {
    load_tile<BN, HDP, THREADS>(Ks + stage * BN * SROW, img + D, ld, t * BN, N, hd);
    load_tile<BN, HDP, THREADS>(Vs + stage * BN * SROW, img + 2 * D, ld, t * BN, N, hd);
    cp_async_commit();
  };
  for (int t = 0; t < NS - 1; ++t) {  // the first tiles (empty groups past the last)
    if (t < ntiles)
      load_kv(t, t);
    else
      cp_async_commit();
  }
  load_tile_scaled<BM, HDP, THREADS>(Qs, img, ld, q0, N, hd, qscale);

  // D = rowsum(do * o) in f32 for the warp's 16 rows, one row at a time
  {
    const bf16* const oimg = out + (size_t)b * N * D + h * hd;
#pragma unroll
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int qi = q0 + r;
      float acc = 0.0f;
      if (qi < n_valid && 4 * lane < hd) {
        const uint2 gw = *reinterpret_cast<const uint2*>(gimg + (size_t)qi * D + 4 * lane);
        const uint2 ow = *reinterpret_cast<const uint2*>(oimg + (size_t)qi * D + 4 * lane);
        const float2 g0 = unpack_bf16(gw.x), g1 = unpack_bf16(gw.y);
        const float2 o0 = unpack_bf16(ow.x), o1 = unpack_bf16(ow.y);
        acc = g0.x * o0.x + g0.y * o0.y + g1.x * o1.x + g1.y * o1.y;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        rowD[r] = acc;
        rowL[r] = qi < N ? lse[((size_t)b * H + h) * N + qi] * LOG2E : 0.0f;
        if (qi < N) dsum[((size_t)b * H + h) * N + qi] = acc;
      }
    }
  }
  __syncthreads();  // rowD, rowL visible to the warp's lanes (the staged q too)
  // the scaled q rows for pass 2, as they are staged here
  for (int i = threadIdx.x; i < BM * (HDP / 8); i += THREADS) {
    const int r = i / (HDP / 8), c = i % (HDP / 8);
    if (q0 + r < N && c < hd / 8)
      *reinterpret_cast<uint4*>(qsc + ((size_t)b * N + q0 + r) * D + h * hd + 8 * c) =
          *reinterpret_cast<const uint4*>(Qs + r * SROW + 8 * c);
  }
  const int g = lane >> 2;
  const float dr[2] = {rowD[warp * 16 + g], rowD[warp * 16 + g + 8]};
  const float lr[2] = {rowL[warp * 16 + g], rowL[warp * 16 + g + 8]};

  float dq[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t % NS, next = t + NS - 1;
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile t (and the block's do rows) visible, tile t - 1 done
    if (next < ntiles)  // into tile t - 1's stage
      load_kv(next, next % NS);
    else
      cp_async_commit();
    const bf16* const Kt = Ks + stage * BN * SROW;
    const bf16* const Vt = Vs + stage * BN * SROW;

    // ---- S = qs K^T and dP = do V^T, 16 rows x 64 keys per warp ----
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (16 * ks >= hdp) continue;
      uint32_t qa[4], ga[4];
      frag_a<HDP>(Qs + warp * 16 * SROW, ks, qa);
      frag_a<HDP>(Gs + warp * 16 * SROW, ks, ga);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kb[4], vb[4];
        frag_b<HDP>(Kt, 16 * np, ks, kb);
        mma(s[2 * np], qa, kb[0], kb[1]);
        mma(s[2 * np + 1], qa, kb[2], kb[3]);
        frag_b<HDP>(Vt, 16 * np, ks, vb);
        mma(dp[2 * np], ga, vb[0], vb[1]);
        mma(dp[2 * np + 1], ga, vb[2], vb[3]);
      }
    }

    // ---- dS = P (dP - D), P = exp(S - lse); keys >= n_valid: P = 0 ----
    const int k0 = t * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
        const float p = key < n_valid ? ex2(fmaf(s[j][e], LOG2E, -lr[e >> 1])) : 0.0f;
        s[j][e] = p * (dp[j][e] - dr[e >> 1]);
      }

    // ---- dQ += dS K, dS rounded to bf16 ----
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
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

  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= N) continue;
    bf16* const drow = dqkv + ((size_t)b * N + qi) * 3 * D + h * hd;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      if (c < hd)
        *reinterpret_cast<uint32_t*>(drow + c) =
            pack_bf16(__fmul_rn(dq[j][2 * r], scale), __fmul_rn(dq[j][2 * r + 1], scale));
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<HDP>)
    long_bwd_keys_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ dsum,
                             const bf16* __restrict__ qsc, bf16* __restrict__ dqkv, int N, int H,
                             int hd, int n_valid, float scale) {
  constexpr int SROW = HDP + 8;
  constexpr int KS = HDP / 16;
  constexpr int NS = STAGES<HDP>;
  constexpr int Q = QT;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* const Ks = reinterpret_cast<bf16*>(smem);    // [BM][SROW]
  bf16* const Vs = Ks + BM * SROW;                   // [BM][SROW]
  bf16* const Qr = Vs + BM * SROW;                   // [NS][Q][SROW] q as it is
  bf16* const Qs = Qr + NS * Q * SROW;               // [NS][Q][SROW] scaled q
  bf16* const Gs = Qs + NS * Q * SROW;               // [NS][Q][SROW] do
  float* const Ls = reinterpret_cast<float*>(Gs + NS * Q * SROW);  // [NS][Q] lse
  float* const Ds = Ls + NS * Q;  // [NS][Q] D
  const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd;
  const size_t ld = 3 * (size_t)D;
  const bf16* const img = qkv + (size_t)b * N * ld + h * hd;
  const bf16* const gimg = dout + (size_t)b * N * D + h * hd;
  const bf16* const qsimg = qsc + (size_t)b * N * D + h * hd;
  const float* const lrow = lse + ((size_t)b * H + h) * N;
  const float* const drow = dsum + ((size_t)b * H + h) * N;
  const int hdp = (hd + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (n_valid + Q - 1) / Q;  // query tiles: rows >= n_valid add nothing

  load_tile<BM, HDP, THREADS>(Ks, img + D, ld, k0, N, hd);
  load_tile<BM, HDP, THREADS>(Vs, img + 2 * D, ld, k0, N, hd);
  auto load_q = [&](int u, int stage) {
    load_tile<Q, HDP, THREADS>(Qr + stage * Q * SROW, img, ld, u * Q, n_valid, hd);
    load_tile<Q, HDP, THREADS>(Qs + stage * Q * SROW, qsimg, D, u * Q, n_valid, hd);
    load_tile<Q, HDP, THREADS>(Gs + stage * Q * SROW, gimg, D, u * Q, n_valid, hd);
    for (int i = threadIdx.x; i < Q; i += THREADS) {
      const int qi = u * Q + i;
      cp_async4_zfill(Ls + stage * Q + i, qi < n_valid ? lrow + qi : lrow, qi < n_valid);
      cp_async4_zfill(Ds + stage * Q + i, qi < n_valid ? drow + qi : drow, qi < n_valid);
    }
    cp_async_commit();
  };
  for (int u = 0; u < NS - 1; ++u) {  // the first with K and V in one commit group
    if (u < nq)
      load_q(u, u);
    else
      cp_async_commit();
  }

  float dk[2 * KS][4], dv[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  const bf16* const Kw = Ks + warp * 16 * SROW;
  const bf16* const Vw = Vs + warp * 16 * SROW;
  const int g = lane >> 2;
  const bool key_ok[2] = {k0 + warp * 16 + g < n_valid, k0 + warp * 16 + g + 8 < n_valid};

  for (int u = 0; u < nq; ++u) {
    const int stage = u % NS, next = u + NS - 1;
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile u visible to every thread, and every warp done with tile u - 1
    if (next < nq)  // into tile u - 1's stage
      load_q(next, next % NS);
    else
      cp_async_commit();
    const bf16* const Qt = Qr + stage * Q * SROW;
    const bf16* const Gt = Gs + stage * Q * SROW;
    const float* const Lt = Ls + stage * Q;
    const float* const Dt = Ds + stage * Q;
    const bf16* const Qst = Qs + stage * Q * SROW;

    // ---- S^T = K qs^T and dP^T = V do^T, 16 keys x Q queries per warp ----
    float st[Q / 8][4], dpt[Q / 8][4];
#pragma unroll
    for (int j = 0; j < Q / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (16 * ks >= hdp) continue;
      uint32_t ka[4], va[4];
      frag_a<HDP>(Kw, ks, ka);
      frag_a<HDP>(Vw, ks, va);
#pragma unroll
      for (int np = 0; np < Q / 16; ++np) {
        uint32_t qb[4], gb[4];
        frag_b<HDP>(Qst, 16 * np, ks, qb);
        mma(st[2 * np], ka, qb[0], qb[1]);
        mma(st[2 * np + 1], ka, qb[2], qb[3]);
        frag_b<HDP>(Gt, 16 * np, ks, gb);
        mma(dpt[2 * np], va, gb[0], gb[1]);
        mma(dpt[2 * np + 1], va, gb[2], gb[3]);
      }
    }

    // ---- P^T = exp(S^T - lse), dS^T = P^T (dP^T - D); padded keys and queries: 0 ----
#pragma unroll
    for (int j = 0; j < Q / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * (lane & 3) + (e & 1);
        const float p = (key_ok[e >> 1] && u * Q + c < n_valid)
                            ? ex2(fmaf(st[j][e], LOG2E, -(Lt[c] * LOG2E)))
                            : 0.0f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - Dt[c]);
      }

    // ---- dV += bf16(P^T) do, dK += bf16(dS^T) q ----
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int dpair = 0; dpair < KS; ++dpair) {
        if (16 * dpair >= hdp) continue;
        uint32_t gb[4], qb[4];
        frag_bt<HDP>(Gt, 16 * kk, dpair, gb);
        mma(dv[2 * dpair], pa, gb[0], gb[1]);
        mma(dv[2 * dpair + 1], pa, gb[2], gb[3]);
        frag_bt<HDP>(Qt, 16 * kk, dpair, qb);
        mma(dk[2 * dpair], da, qb[0], qb[1]);
        mma(dk[2 * dpair + 1], da, qb[2], qb[3]);
      }
    }
  }

  const int key0 = k0 + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key0 + 8 * r;
    if (kj >= N) continue;
    bf16* const row = dqkv + ((size_t)b * N + kj) * 3 * D + h * hd;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      if (c < hd) {
        *reinterpret_cast<uint32_t*>(row + D + c) =
            pack_bf16(__fmul_rn(dk[j][2 * r], scale), __fmul_rn(dk[j][2 * r + 1], scale));
        *reinterpret_cast<uint32_t*>(row + 2 * D + c) = pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
      }
    }
  }
}

template <int HDP>
int launch(const void* qkv, const void* out, const void* dout, const void* lse, void* dsum,
           void* qsc, void* dqkv, int B, int N, int H, int hd, int n_valid, float qscale,
           float scale, cudaStream_t st) {
  auto rows = long_bwd_rows_mma_kernel<HDP>;
  auto keys = long_bwd_keys_mma_kernel<HDP>;
  const size_t rs = rows_smem<HDP>(), ks = keys_smem<HDP>();
  cudaError_t e = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(rs));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(keys, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(ks));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + BM - 1) / BM, H, B);
  rows<<<grid, THREADS, rs, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<float*>(dsum),
      static_cast<bf16*>(qsc), static_cast<bf16*>(dqkv), N, H, hd, n_valid, qscale, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  keys<<<grid, THREADS, ks, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<const bf16*>(qsc), static_cast<bf16*>(dqkv), N, H, hd, n_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dqkv [B, N, 3*H*hd] bf16 of qvt_attention_long_mma for the output gradient
// do [B, N, H*hd] bf16, from the forward's output `out` [B, N, H*hd] and
// log-sum-exp `lse` [B, H, N] f32; scratch from pass 1 to pass 2: dsum
// [B, H, N] f32 (D) and qsc [B, N, H*hd] bf16 (the scaled q). qscale:
// hd^-0.5 in bf16 (the forward's q scaling); scale: hd^-0.5 in f32. Two
// launches on `stream`.
extern "C" int qvt_attention_long_bwd_mma(const void* qkv, const void* out, const void* dout,
                                          const void* lse, void* dsum, void* qsc, void* dqkv,
                                          int B, int N, int H, int hd, int n_valid, float qscale,
                                          float scale, void* stream) {
  if (hd <= 0 || hd > 128 || hd % 8 || N <= 0 || n_valid <= 0 || n_valid > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch<64>(qkv, out, dout, lse, dsum, qsc, dqkv, B, N, H, hd, n_valid, qscale, scale,
                      st);
  return launch<128>(qkv, out, dout, lse, dsum, qsc, dqkv, B, N, H, hd, n_valid, qscale, scale,
                     st);
}
