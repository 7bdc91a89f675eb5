// The tile of the short-sequence tensor-core attention over the packed bf16
// qkv (csrc/attention_q_mma.cu: K3, kernel A in bf16, the bf16 K8), as a
// __device__ function: attention_q_mma.cu's kernels run one tile per block,
// and K9's cooperative kernel (csrc/megablock.cu) runs K3's form of it as its
// attention stage, a persistent loop over the same tiles. One definition of
// the pass code is what keeps K9's attention bit-identical to K3's. The
// design and numerics are attention_q_mma.cu's (its header).
#pragma once

#include "common.cuh"
#include "mma_tile.cuh"

namespace qvt_attn_q {

using namespace qvt_mma;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // query rows per block
constexpr int BN = 64;          // keys per tile of the passes
// H100: the dynamic shared memory one block may opt into (bytes)
constexpr size_t SMEM_MAX = 232448;

template <int HDP>
constexpr int SROW = HDP + 8;  // a tile row: an odd number of 16-byte chunks

// threads per SM the register budget must allow: the resident form at hd
// <= 64 512 (128 registers a thread), the streamed form and hd 128 256
template <int HDP, bool RESIDENT>
constexpr int MIN_BLOCKS = (HDP <= 64 && RESIDENT ? 512 : 256) / THREADS;

template <int HDP>
constexpr int STAGES = HDP <= 64 ? 3 : 2;

// rows of the resident K and V: N rounded up to 16, at least the q rows
// staged in V's place
__host__ __device__ inline int resident_rows(int n) {
  const int r = (n + 15) & ~15;
  return r < BM ? BM : r;
}

template <int HDP>
size_t resident_smem(int n) {
  return 2 * sizeof(bf16) * (size_t)resident_rows(n) * SROW<HDP>;
}

template <int HDP>
constexpr size_t stream_smem() {  // q; K and V per stage
  return sizeof(bf16) * (size_t)SROW<HDP> * (BM + 2 * STAGES<HDP> * BN);
}

// One tile of attention_q_mma.cu's kernels: query rows [BM qt, BM qt + BM) of head h of
// image b, on the block's THREADS threads (threadIdx.x 0 .. THREADS - 1).
// SCALE_AFTER (K8): q enters the dot unscaled and the f32 score is scaled
// after it.
template <int HDP, bool QOUT, bool IN_FQ, bool RESIDENT, bool SCALE_AFTER>
__device__ __forceinline__ void attention_q_mma_tile(
    const bf16* __restrict__ qkv, const float* __restrict__ qs, void* __restrict__ out, int N,
    int H, int hd, int n_valid, float scale, float inv_s, float zp, float qmax, float fq_min,
    float fq_max, uint8_t* smem_raw, int qt, int h, int b) {
  constexpr int S = SROW<HDP>;
  constexpr int KS = HDP / 16;  // k-steps of the score dot; 16-column pairs of o
  constexpr int NS = STAGES<HDP>;
  bf16* const smem = reinterpret_cast<bf16*>(smem_raw);
  const int q0 = qt * BM;
  const int D = H * hd;
  const size_t ld = 3 * (size_t)D;
  const bf16* const img = qkv + (size_t)b * N * ld + h * hd;
  const int hdp = (hd + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = (N + BN - 1) / BN;  // key tiles per pass
  const int total = 2 * nt;          // pass p: tiles p nt .. (p + 1) nt - 1
  const int R = RESIDENT ? resident_rows(N) : 0;

  float fs = 1.0f, fz = 0.0f;
  if constexpr (IN_FQ) {
    fs = qs[0];
    fz = qs[1];
  }
  const auto fq = [=](float x) { return qvt::fake_quant(x, fs, fz, fq_min, fq_max); };
  const auto q_map = [=](float x) {  // (fake-quant, back to bf16,) times hd^-0.5
    if constexpr (IN_FQ) x = qvt::round_bf16(qvt::fake_quant(x, fs, fz, fq_min, fq_max));
    return SCALE_AFTER ? x : __fmul_rn(x, scale);
  };

  // resident: K [R][S], V [R][S] (q staged in V's place first);
  // streaming: q [BM][S], K [NS][BN][S], V [NS][BN][S]
  bf16* const Ks = RESIDENT ? smem : smem + BM * S;
  bf16* const Vs = RESIDENT ? smem + (size_t)R * S : Ks + NS * BN * S;
  bf16* const Qs = RESIDENT ? Vs : smem;

  // tile t of the streamed sequence into ring stage `stage`: its K tile,
  // and in pass 2 its V tile; one commit group
  const auto load = [&](int t, int stage) {
    const int k0 = (t % nt) * BN;
    stage_rows<HDP, THREADS>(Ks + stage * BN * S, img + D, ld, k0, BN, N, hd);
    if (t >= nt) stage_rows<HDP, THREADS>(Vs + stage * BN * S, img + 2 * D, ld, k0, BN, N, hd);
    cp_async_commit();
  };
  const auto map_tile = [&](int t, int stage) {  // in_fq on a landed ring tile
    const int k0 = (t % nt) * BN;
    map_rows<HDP, THREADS>(Ks + stage * BN * S, k0, BN, N, hd, fq);
    if (t >= nt) map_rows<HDP, THREADS>(Vs + stage * BN * S, k0, BN, N, hd, fq);
  };

  stage_rows<HDP, THREADS>(Qs, img, ld, q0, BM, N, hd);
  if constexpr (RESIDENT) {
    stage_rows<HDP, THREADS>(Ks, img + D, ld, 0, R, N, hd);
    cp_async_commit();
    cp_async_wait<0>();
    if constexpr (IN_FQ) map_rows<HDP, THREADS>(Ks, 0, R, N, hd, fq);
  } else {
    cp_async_commit();
    cp_async_wait<0>();
  }
  if constexpr (IN_FQ || !SCALE_AFTER) map_rows<HDP, THREADS>(Qs, q0, BM, N, hd, q_map);
  __syncthreads();

  // the warp's 16 q rows as A fragments
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    if (16 * ks < hdp) frag_a<HDP>(Qs + warp * 16 * S, ks, qf[ks]);

  if constexpr (RESIDENT) {
    __syncthreads();  // every warp has its q fragments: V may land over them
    stage_rows<HDP, THREADS>(Vs, img + 2 * D, ld, 0, R, N, hd);
    cp_async_commit();
  } else {
    for (int t = 0; t < NS - 1; ++t) {  // the first tiles (empty groups past the last)
      if (t < total)
        load(t, t);
      else
        cp_async_commit();
    }
  }

  float o[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {-1e30f, -1e30f};  // rows g and g + 8: the running max (quad-wide)
  float l[2] = {0.0f, 0.0f};      // the sum of exp2((s - m) log2e) (the lane's keys)
  float ml[2] = {0.0f, 0.0f}, inv_l[2] = {0.0f, 0.0f};  // m log2e, 1 / the row sum

  for (int t = 0; t < total; ++t) {
    const int pass = t / nt, k0 = (t - pass * nt) * BN;
    const int ng = min(BN, N - k0 + 15) / 16;  // key groups of 16 holding keys < N
    const bf16* Kt;
    const bf16* Vt;
    if constexpr (RESIDENT) {
      if (t == nt) {  // V has landed (and is fake-quantized) before pass 2
        cp_async_wait<0>();
        if constexpr (IN_FQ) map_rows<HDP, THREADS>(Vs, 0, R, N, hd, fq);
        __syncthreads();
      }
      Kt = Ks + k0 * S;
      Vt = Vs + k0 * S;
    } else {
      const int stage = t % NS, next = t + NS - 1;
      cp_async_wait<NS - 2>();
      if constexpr (IN_FQ) map_tile(t, stage);
      __syncthreads();  // tile t visible to every warp, and every warp done with tile t - 1
      if (next < total)  // into tile t - 1's stage
        load(next, next % NS);
      else
        cp_async_commit();
      Kt = Ks + stage * BN * S;
      Vt = Vs + stage * BN * S;
    }

    // ---- s: 16 rows x 64 keys per warp ----
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (16 * ks >= hdp) continue;
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        if (np >= ng) continue;
        uint32_t kb[4];  // keys 16 np + g: kb[0], kb[1]; keys 16 np + 8 + g: kb[2], kb[3]
        frag_b<HDP>(Kt, 16 * np, ks, kb);
        mma(s[2 * np], qf[ks], kb[0], kb[1]);
        mma(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }
    if constexpr (SCALE_AFTER) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
    }
    if (k0 + BN > n_valid) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * (lane & 3) + (e & 1) >= n_valid) s[j][e] = -1e30f;
    }

    if (pass == 0) {
      // ---- pass 1: the running max and sum (K5a's online rescale) ----
      float mx[2] = {m[0], m[1]}, rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        l[r] *= ex2((m[r] - mx[r]) * LOG2E);
        m[r] = mx[r];
        ml[r] = mx[r] * LOG2E;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e >> 1] += ex2(fmaf(s[j][e], LOG2E, -ml[e >> 1]));
      l[0] += rs[0];
      l[1] += rs[1];
      if (t == nt - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          inv_l[r] = 1.0f / l[r];
        }
      }
      continue;
    }

    // ---- pass 2: o += p v, p = exp2((s - m) log2e) / l rounded to bf16 ----
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      if (kk >= ng) continue;
      float p[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[u][e] = ex2(fmaf(s[2 * kk + u][e], LOG2E, -ml[e >> 1])) * inv_l[e >> 1];
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        if (16 * dp >= hdp) continue;
        uint32_t vb[4];
        frag_bt<HDP>(Vt, 16 * kk, dp, vb);
        mma(o[2 * dp], pa, vb[0], vb[1]);
        mma(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }
  if constexpr (!RESIDENT) cp_async_wait<0>();

  // ---- epilogue: o quantized to shifted int8, or rounded to bf16 ----
  const int row0 = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= N) continue;
    const size_t at = ((size_t)b * N + qi) * D + h * hd;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      if (c >= hd) continue;
      if constexpr (QOUT) {
        const uint8_t lo =
            static_cast<uint8_t>(qvt::quantize_shifted(o[j][2 * r], inv_s, zp, qmax));
        const uint8_t hi =
            static_cast<uint8_t>(qvt::quantize_shifted(o[j][2 * r + 1], inv_s, zp, qmax));
        *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(out) + at + c) =
            static_cast<uint16_t>(lo | (hi << 8));
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + at + c) =
            pack_bf16(o[j][2 * r], o[j][2 * r + 1]);
      }
    }
  }
}

}  // namespace qvt_attn_q
