// The pipelined RESID_LN_Q row tile of K2c (csrc/int8_gemm.cu; its design is
// that file's header) as a __device__ function: int8_gemm.cu's kernel runs one
// tile per block, and K9's cooperative kernel (csrc/megablock.cu) runs its
// proj and fc2 stages as persistent loops over the same tiles, so y and q are
// the chain's bit for bit.
#pragma once

#include "gemm_tile.cuh"
#include "mma_tile.cuh"

namespace qvt_resid_ln {

using namespace qvt;
using namespace qvt::gemm;

// ---- RESID_LN_Q (K2c), pipelined ----
constexpr int RL_THREADS = 256;  // 8 warps
constexpr int RL_NC = 192;       // columns per pass
constexpr int RL_STAGES = 3;
constexpr int RL_BK = 64;            // k bytes per stage
constexpr int RL_ROW = RL_BK + 16;   // bytes per A / B tile row (an odd number of 16-byte chunks)

// the ring, the block's f32 y in rows of N + 4, and five per-column
// constants (colsum, s_x * w_scale, bias, gamma, beta)
constexpr size_t rl_smem_bytes(int bm, int n) {
  return (size_t)RL_STAGES * (bm + RL_NC) * RL_ROW + (size_t)bm * (n + 4) * sizeof(float) +
         5 * sizeof(float) * (size_t)n;
}

// an int8 tile of RL_ROW-byte rows read as bf16 pairs: its 32-byte k-steps
// are the 16-element k-steps of a [rows][RL_BK / 2 + 8] bf16 tile, so the
// bf16 ldmatrix helpers of mma_tile.cuh give the m16n8k32.s8 fragments
constexpr int RL_HALF = RL_BK / 2;
__device__ __forceinline__ const qvt_mma::bf16* rl_pairs(const uint8_t* p) {
  static_assert(RL_ROW == 2 * (RL_HALF + 8), "int8 rows must be bf16 rows of RL_BK / 2");
  return reinterpret_cast<const qvt_mma::bf16*>(p);
}

// One block's tile: rows [m0, m0 + BM) x all N, on the block's RL_THREADS
// threads (threadIdx.x 0 .. 255); shared memory from smem on,
// rl_smem_bytes(BM, N). 8 warps as WM (rows) x 8 / WM (columns); a warp owns
// MI 16-row tiles x NI 8-column tiles of a pass.
template <int BM, int WM, typename OutT, typename ResT>
__device__ __forceinline__ void resid_ln_tile(const GemmParams& p, uint8_t* smem, int m0) {
  constexpr int WN = 8 / WM, MI = BM / (16 * WM), NI = RL_NC / (8 * WN);
  constexpr int STAGE = (BM + RL_NC) * RL_ROW;
  static_assert(MI >= 1 && NI >= 2 && BM == 16 * WM * MI && RL_NC == 8 * WN * NI, "layout");
  float* const Ys = reinterpret_cast<float*>(smem + RL_STAGES * STAGE);  // [BM][N + 4]
  int* const Cs = reinterpret_cast<int*>(Ys + BM * (p.N + 4));  // colsum
  float* const Sw = reinterpret_cast<float*>(Cs + p.N);           // s_x * w_scale
  float* const Bi = Sw + p.N;                                      // bias
  float* const Ga = Bi + p.N;                                      // LN gamma
  float* const Be = Ga + p.N;                                      // LN beta
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / WN) * MI * 16, wc = (warp % WN) * NI * 8;  // the warp's tile
  const int nk = (p.K + RL_BK - 1) / RL_BK, ldy = p.N + 4;
  const int8_t* const a = static_cast<const int8_t*>(p.a);
  const ResT* const res = static_cast<const ResT*>(p.residual);

  // k-step kt of the pass at column n0 into ring stage `stage` (bytes past
  // K zero-filled): one group
  auto load = [&](int kt, int stage, int n0) {
    constexpr int CH = RL_BK / 16;
    uint8_t* const As = smem + stage * STAGE;
    uint8_t* const Bs = As + BM * RL_ROW;
    const int k0 = kt * RL_BK;
    for (int c = tid; c < BM * CH; c += RL_THREADS) {
      const int r = c / CH, ch = c % CH;
      const bool ok = m0 + r < p.M && k0 + 16 * ch < p.K;
      qvt_mma::cp_async16_zfill(As + r * RL_ROW + 16 * ch,
                                ok ? a + (size_t)(m0 + r) * p.K + k0 + 16 * ch : a, ok);
    }
    for (int c = tid; c < RL_NC * CH; c += RL_THREADS) {
      const int r = c / CH, ch = c % CH;
      const bool ok = n0 + r < p.N && k0 + 16 * ch < p.K;
      qvt_mma::cp_async16_zfill(Bs + r * RL_ROW + 16 * ch,
                                ok ? p.w + (size_t)(n0 + r) * p.K + k0 + 16 * ch : p.w, ok);
    }
    qvt_mma::cp_async_commit();
  };

  // the per-column constants in shared memory (visible after the first
  // k-step's barrier): the epilogue and the LayerNorm then issue no global
  // load behind an output store that might alias it
  for (int c = tid; c < p.N; c += RL_THREADS) {
    Cs[c] = p.colsum[c];
    Sw[c] = dequant_scale(p, c);
    Bi[c] = p.bias != nullptr ? p.bias[c] : 0.0f;
    Ga[c] = p.gamma[c];
    Be[c] = p.beta[c];
  }
  const bool has_bias = p.bias != nullptr;

  for (int n0 = 0; n0 < p.N; n0 += RL_NC) {
    int acc[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
    for (int s = 0; s < RL_STAGES - 1; ++s) {
      if (s < nk)
        load(s, s, n0);
      else
        qvt_mma::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      qvt_mma::cp_async_wait<RL_STAGES - 2>();
      __syncthreads();  // k-step kt visible, and every warp done with kt - 1's stage
      const int nxt = kt + RL_STAGES - 1;
      if (nxt < nk)
        load(nxt, nxt % RL_STAGES, n0);
      else
        qvt_mma::cp_async_commit();
      const uint8_t* const As = smem + (kt % RL_STAGES) * STAGE;
      const qvt_mma::bf16* const Bp = rl_pairs(As + BM * RL_ROW);
#pragma unroll
      for (int ks = 0; ks < RL_BK / 32; ++ks) {
        uint32_t af[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          qvt_mma::frag_a<RL_HALF>(rl_pairs(As + (wr + 16 * mi) * RL_ROW), ks, af[mi]);
#pragma unroll
        for (int q = 0; q < NI / 2; ++q) {
          uint32_t bb[4];  // n-tiles 2q (bb[0], bb[1]) and 2q + 1 (bb[2], bb[3])
          qvt_mma::frag_b<RL_HALF>(Bp, wc + 16 * q, ks, bb);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
            mma_s8(acc[mi][2 * q], af[mi], b0);
            mma_s8(acc[mi][2 * q + 1], af[mi], b1);
          }
        }
        if constexpr (NI % 2 == 1) {  // the last n-tile: rows wc + 8 (NI - 1) ..
          uint32_t bb[2];
          const qvt_mma::bf16* const at =
              Bp + (wc + 8 * (NI - 1) + (lane & 7)) * (RL_HALF + 8) + 16 * ks +
              ((lane >> 3) & 1) * 8;
          asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                       : "=r"(bb[0]), "=r"(bb[1])
                       : "r"(qvt_mma::smem_addr(at)));
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) mma_s8(acc[mi][NI - 1], af[mi], bb);
        }
      }
    }
    qvt_mma::cp_async_wait<0>();
    __syncthreads();  // every warp done with the ring before the next pass refills it

    // the pass's y = dequant + residual (gemm_tile.cuh's dequant_value),
    // every load first, then to Ys and the output
    float yv[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = m0 + wr + 16 * mi + g + (r >= 2 ? 8 : 0);
          const int col = n0 + wc + 8 * ni + 2 * t + (r & 1);
          yv[mi][ni][r] = 0.0f;
          if (row >= p.M || col >= p.N) continue;
          const float y =
              dequant_value(acc[mi][ni][r], p.z_s, Cs[col], Sw[col], has_bias, Bi[col]);
          yv[mi][ni][r] = __fadd_rn(y, to_f32(res[(size_t)row * p.N + col]));
        }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int lr = wr + 16 * mi + g + (r >= 2 ? 8 : 0);
          const int row = m0 + lr;
          const int col = n0 + wc + 8 * ni + 2 * t + (r & 1);
          if (row >= p.M || col >= p.N) continue;
          Ys[lr * ldy + col] = yv[mi][ni][r];
          static_cast<OutT*>(p.y)[(size_t)row * p.N + col] = from_f32<OutT>(yv[mi][ni][r]);
        }
  }
  __syncthreads();

  for (int lr = warp; lr < BM; lr += RL_THREADS / 32) {
    const int row = m0 + lr;
    if (row >= p.M) continue;
    const float* yr = Ys + lr * ldy;
    const float2 st = warp_row_stats([&](int c) { return yr[c]; }, p.N, p.eps);
    for (int c = lane; c < p.N; c += 32)
      p.q[(size_t)row * p.N + c] = quantize_shifted(ln_affine(yr[c], st, Ga[c], Be[c]), p.inv_s,
                                                    p.zp, p.qmax);
  }
}

}  // namespace qvt_resid_ln
