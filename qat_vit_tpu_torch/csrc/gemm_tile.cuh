// The int8 GEMM tile bodies of csrc/megablock.cu (K9: grid-stride loops over
// the tiles of the four GEMM stages inside one cooperative launch), and the
// epilogue arithmetic: csrc/int8_gemm_wgmma.cu (K2a, K2b, K7) and
// int8_gemm.cu's K2c call dequant_value / dequant_scale and activation. One definition of the
// arithmetic is what makes the fused block bit-identical to the launch chain.
//
// Math. A is shifted int8 [M, K] (uint8 grid - 128), W is int8 [K, N] in the
// JAX export's layout, colsum[n] = sum_k W[k, n]. With z_s = zp - 128:
//   y = float(acc - z_s * colsum[n]) * (s_x * w_scale[n]) + bias[n]
// PLAIN writes y (f32 or bf16). PLAIN_Q8 writes y and, for the first q_n
// columns, quantize(y) from the f32 y (not from the rounded output) into an
// [M, q_n] int8 array: the q and k of a qkv GEMM on the qkv out_q grid, for
// the int8 score dots of csrc/attention_long_q_mma.cu (K6's int8_scores, JAX
// ops/long_block_kernel.py `_q8(y[:, :2D], ...)`). GELU_Q writes
// quantize(act(y)), act = the
// tanh GELU of jax.nn.gelu(approximate=True) or quick-GELU y*sigmoid(1.702y).
// RESID_LN_Q adds the residual in f32, writes y, and writes quantize(LN(y))
// with f32 statistics over the whole row. K7 (int8_gemm_wgmma.cu) quantizes
// a float A (f32 or bf16) with the a_* grid first: clamp(rint(x * (1/s_x) +
// zp), 0, qmax) - 128.
//
// A tile body runs on a group of 128 threads = 2 x 2 warps. Each k-step of
// 64 bytes stages an A tile [BM x 64] and a W tile [64 x 64] in shared
// memory, synchronously, and each warp issues mma.sync.m16n8k32.s8 on its
// (BM/2 x 32) sub-tile with int32 accumulators in registers. The W tile is
// transposed on the way into shared memory (4x4 byte transposes with
// __byte_perm) so that a B fragment, four consecutive k of one column, is
// one 32-bit word; no pre-transposed copy of the weight exists. Rows are
// padded to 80 bytes (20 words), which makes the fragment reads free of bank
// conflicts. Ragged M and N are masked. K is a multiple of 16: the A chunks
// and W rows of the last k-tile that lie past K are zero-filled (a branch
// never taken at K % 64 = 0, so K9's bits do not depend on it).
//
// LayerNorm needs whole rows, so the RESID_LN_Q body owns BM = 32 rows and
// ALL N columns: it loops over the N/64 column tiles, keeps the f32 y of its
// rows in shared memory (32 x N x 4 bytes) and computes the row statistics
// from there, one warp per row.
//
// HINT = true loads W with an L2 evict_last policy and A with evict_first
// (ld.global.L2::cache_hint; createpolicy), so that a whole model's weights
// stay in the 50 MB L2 while activations stream past them (K9b). The W
// words go through registers for the transpose, so the hinted loads are
// ld.global, not cp.async. Hints change no value.
#pragma once

#include "common.cuh"

namespace qvt {
namespace gemm {

constexpr int BK = 64;         // k bytes per shared-memory tile
constexpr int BKP = BK + 16;   // padded row stride in bytes (20 words)
constexpr int BN = 64;         // columns per tile
constexpr int THREADS = 128;   // one group: 4 warps, 2 x 2
constexpr int BM_TILED = 64;   // rows per tile, PLAIN / GELU_Q
constexpr int BM_ROWS = 32;    // rows per tile, RESID_LN_Q

enum Epilogue { EPI_PLAIN = 0, EPI_GELU_Q = 1, EPI_RESID_LN_Q = 2, EPI_PLAIN_Q8 = 3 };

struct GemmParams {
  const void* a;           // [M, K] shifted int8 (K7: f32 or bf16, quantized first)
  const int8_t* w;         // [K, N]
  const int32_t* colsum;   // [N]
  const float* bias;       // [N] or null
  const float* wscale;     // [N] when ws_per_channel, else unused
  const void* residual;    // [M, N] (RESID_LN_Q)
  const float* gamma;      // [N] (RESID_LN_Q)
  const float* beta;       // [N] (RESID_LN_Q)
  void* y;                 // [M, N] float output (PLAIN, RESID_LN_Q)
  int8_t* q;               // [M, N] int8 output (GELU_Q, RESID_LN_Q); [M, q_n] (PLAIN_Q8)
  int M, N, K;
  int ws_per_channel;
  int act;                 // 0 tanh-GELU, 1 quick-GELU
  int w_vec;               // N % 4 == 0: W rows read as 32-bit words
  float ws0;               // per-tensor weight scale
  float s_x;               // input activation scale
  int z_s;                 // input zero-point - 128
  float inv_s, zp, qmax;   // output quantize grid
  float eps;
  float a_inv_s, a_zp, a_qmax;  // input quantize grid of a float A (K7)
  int q_n;                 // PLAIN_Q8: the first q_n columns are also quantized
};

__host__ __device__ constexpr int tiled_smem_bytes() { return (BM_TILED + BN) * BKP; }
__host__ __device__ constexpr int resid_ln_smem_bytes(int n) {
  return (BM_ROWS + BN) * BKP + BM_ROWS * n * static_cast<int>(sizeof(float));
}

// The 128 threads that run one tile: thread index in the group, and the
// barrier that syncs them (0: the whole block, __syncthreads; else a named
// barrier of 128 threads, for a block that runs two groups side by side).
struct Group {
  int tid;
  int bar;
  __device__ __forceinline__ void sync() const {
    if (bar == 0)
      __syncthreads();
    else
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
  }
};

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

template <bool HINT>
__device__ __forceinline__ uint32_t ld_w32(const int8_t* p, uint64_t pol) {
  if constexpr (HINT) {
    uint32_t v;
    asm volatile("ld.global.L2::cache_hint.b32 %0, [%1], %2;\n" : "=r"(v) : "l"(p), "l"(pol));
    return v;
  } else {
    return *reinterpret_cast<const uint32_t*>(p);
  }
}

template <bool HINT>
__device__ __forceinline__ int4 ld_a128(const void* p, uint64_t pol) {
  if constexpr (HINT) {
    int4 v;
    asm volatile("ld.global.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p), "l"(pol));
    return v;
  } else {
    return *reinterpret_cast<const int4*>(p);
  }
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the [BM x BK] tile of the shifted-int8 A at (m0, k0), zeros past M and K
template <int BM, bool HINT>
__device__ __forceinline__ void load_a_tile(const GemmParams& p, uint8_t* As, int m0, int k0,
                                            const Group& g) {
  const uint64_t pol = HINT ? l2_evict_first() : 0;
  for (int c = g.tid; c < BM * (BK / 16); c += THREADS) {
    const int r = c / (BK / 16), col = (c % (BK / 16)) * 16;
    const int gm = m0 + r;
    int4 v = make_int4(0, 0, 0, 0);
    if (gm < p.M && k0 + col < p.K)
      v = ld_a128<HINT>(static_cast<const int8_t*>(p.a) + (size_t)gm * p.K + k0 + col, pol);
    *reinterpret_cast<int4*>(As + r * BKP + col) = v;
  }
}

// W tile [64 k x 64 n] -> Bs[n][k]: each unit is a 4 x 4 byte block read as
// four row words and written as four column words; rows past K are zeros.
template <bool HINT>
__device__ __forceinline__ void load_w_tile(const GemmParams& p, uint8_t* Bs, int n0, int k0,
                                            const Group& g) {
  constexpr int NU = BN / 4;
  const uint64_t pol = HINT ? l2_evict_last() : 0;
  for (int u = g.tid; u < (BK / 4) * NU; u += THREADS) {
    const int ku = u / NU, nu = u % NU;
    const int k = k0 + ku * 4, n = n0 + nu * 4;
    uint32_t r[4];
    if (k >= p.K) {  // past K (K % 16 = 0: the unit's four rows together)
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = 0;
    } else if (p.w_vec && n + 3 < p.N) {
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = ld_w32<HINT>(p.w + (size_t)(k + i) * p.N + n, pol);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t v = 0;
        for (int j = 0; j < 4; ++j)
          if (n + j < p.N)
            v |= static_cast<uint32_t>(static_cast<uint8_t>(p.w[(size_t)(k + i) * p.N + n + j]))
                 << (8 * j);
        r[i] = v;
      }
    }
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    uint32_t* col = reinterpret_cast<uint32_t*>(Bs + (nu * 4) * BKP + ku * 4);
    col[0] = __byte_perm(t0, t2, 0x5410);
    col[BKP / 4] = __byte_perm(t0, t2, 0x7632);
    col[2 * BKP / 4] = __byte_perm(t1, t3, 0x5410);
    col[3 * BKP / 4] = __byte_perm(t1, t3, 0x7632);
  }
}

// acc[mi][ni][r]: rows wm + mi*16 + g (+8 for r >= 2), cols wn + ni*8 + 2t (+1 for odd r)
template <int BM, bool HINT>
__device__ __forceinline__ void gemm_tile(const GemmParams& p, uint8_t* As, uint8_t* Bs,
                                          int m0, int n0, int (&acc)[BM / 32][4][4],
                                          const Group& grp) {
  constexpr int MI = BM / 32;
  const int lane = grp.tid & 31, warp = grp.tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * (BM / 2), wn = (warp & 1) * (BN / 2);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    load_a_tile<BM, HINT>(p, As, m0, k0, grp);
    load_w_tile<HINT>(p, Bs, n0, k0, grp);
    grp.sync();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[MI][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const uint8_t* base = As + (wm + mi * 16 + g) * BKP + ks + t * 4;
        af[mi][0] = ld32(base);
        af[mi][1] = ld32(base + 8 * BKP);
        af[mi][2] = ld32(base + 16);
        af[mi][3] = ld32(base + 8 * BKP + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* base = Bs + (wn + ni * 8 + g) * BKP + ks + t * 4;
        bf[ni][0] = ld32(base);
        bf[ni][1] = ld32(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    grp.sync();
  }
}

// column n's dequant scale, s_x * w_scale[n]
__device__ __forceinline__ float dequant_scale(const GemmParams& p, int n) {
  return __fmul_rn(p.s_x, p.ws_per_channel ? p.wscale[n] : p.ws0);
}

// dequant's arithmetic on values (the kernels that stage a tile's colsum,
// scale and bias in shared memory call it directly)
__device__ __forceinline__ float dequant_value(int acc, int z_s, int colsum, float sw,
                                               bool has_bias, float bias) {
  const float y = __fmul_rn(static_cast<float>(acc - z_s * colsum), sw);
  return has_bias ? __fadd_rn(y, bias) : y;
}

__device__ __forceinline__ float dequant(const GemmParams& p, int acc, int n) {
  const bool has_bias = p.bias != nullptr;
  return dequant_value(acc, p.z_s, p.colsum[n], dequant_scale(p, n), has_bias,
                       has_bias ? p.bias[n] : 0.0f);
}

__device__ __forceinline__ float activation(float y, int act) {
  if (act == 1) {  // quick-GELU, exact
    return __fmul_rn(y, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-1.702f * y))));
  }
  // jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))))
  const float k = 0.7978845608028654f;
  const float x3 = __fmul_rn(__fmul_rn(y, y), y);
  const float inner = __fmul_rn(k, __fadd_rn(y, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(y, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// PLAIN and GELU_Q (K9): the (64-row, 64-column) output tile at (m0, n0)
template <int EPI, typename OutT, bool HINT>
__device__ __forceinline__ void tiled_body(const GemmParams& p, uint8_t* smem, int m0, int n0,
                                           const Group& grp) {
  constexpr int BM = BM_TILED;
  uint8_t* As = smem;
  uint8_t* Bs = smem + BM * BKP;
  int acc[BM / 32][4][4];
  gemm_tile<BM, HINT>(p, As, Bs, m0, n0, acc, grp);

  const int lane = grp.tid & 31, warp = grp.tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * (BM / 2), wn = (warp & 1) * (BN / 2);
#pragma unroll
  for (int mi = 0; mi < BM / 32; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + mi * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + ni * 8 + 2 * t + (r & 1);
        if (row >= p.M || col >= p.N) continue;
        const float y = dequant(p, acc[mi][ni][r], col);
        const size_t o = (size_t)row * p.N + col;
        if constexpr (EPI == EPI_GELU_Q)
          p.q[o] = quantize_shifted(activation(y, p.act), p.inv_s, p.zp, p.qmax);
        else
          static_cast<OutT*>(p.y)[o] = from_f32<OutT>(y);
      }
}

// RESID_LN_Q: the 32 rows from m0, all N columns
template <typename OutT, typename ResT, bool HINT>
__device__ __forceinline__ void resid_ln_body(const GemmParams& p, uint8_t* smem, int m0,
                                              const Group& grp) {
  constexpr int BM = BM_ROWS;
  uint8_t* As = smem;
  uint8_t* Bs = smem + BM * BKP;
  float* Ys = reinterpret_cast<float*>(smem + (BM + BN) * BKP);
  const int lane = grp.tid & 31, warp = grp.tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * (BM / 2), wn = (warp & 1) * (BN / 2);
  const ResT* res = static_cast<const ResT*>(p.residual);

  for (int n0 = 0; n0 < p.N; n0 += BN) {
    int acc[BM / 32][4][4];
    gemm_tile<BM, HINT>(p, As, Bs, m0, n0, acc, grp);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int lr = wm + g + (r >= 2 ? 8 : 0);
        const int row = m0 + lr;
        const int col = n0 + wn + ni * 8 + 2 * t + (r & 1);
        if (row >= p.M || col >= p.N) continue;
        const size_t o = (size_t)row * p.N + col;
        const float y = __fadd_rn(dequant(p, acc[0][ni][r], col), to_f32(res[o]));
        Ys[lr * p.N + col] = y;
        static_cast<OutT*>(p.y)[o] = from_f32<OutT>(y);
      }
  }
  grp.sync();

  for (int lr = warp; lr < BM; lr += THREADS / 32) {
    const int row = m0 + lr;
    if (row >= p.M) continue;
    const float* yr = Ys + lr * p.N;
    const float2 st = warp_row_stats([&](int c) { return yr[c]; }, p.N, p.eps);
    for (int c = lane; c < p.N; c += 32) {
      const float z = ln_affine(yr[c], st, p.gamma[c], p.beta[c]);
      p.q[(size_t)row * p.N + c] = quantize_shifted(z, p.inv_s, p.zp, p.qmax);
    }
  }
  // the next tile of this group writes Ys again only after its first
  // k-step's barrier, which every warp reaches after this loop
}

}  // namespace gemm
}  // namespace qvt
