// int8 x int8 -> int32 GEMM with three fused epilogues, for sm_90a.
//
// Replaces (TPU, Pallas):
//   qat_vit_tpu/ops/fused_serve.py::_plain_kernel       (K2a)  -> EPI_PLAIN
//   qat_vit_tpu/ops/fused_serve.py::_gelu_q_kernel      (K2b)  -> EPI_GELU_Q
//   qat_vit_tpu/ops/fused_serve.py::_resid_ln_q_kernel  (K2c)  -> EPI_RESID_LN_Q
// and the four GEMM stages of qat_vit_tpu/ops/block_kernel.py::_model_kernel
// (K4), which the port runs as a chain of these launches.
//
// Math. A is shifted int8 [M, K] (uint8 grid - 128), W is int8 [K, N] in the
// JAX export's layout, colsum[n] = sum_k W[k, n]. With z_s = zp - 128:
//   y = float(acc - z_s * colsum[n]) * (s_x * w_scale[n]) + bias[n]
// PLAIN writes y (f32 or bf16). GELU_Q writes quantize(act(y)), act = the
// tanh GELU of jax.nn.gelu(approximate=True) or quick-GELU y*sigmoid(1.702y).
// RESID_LN_Q adds the residual in f32, writes y, and writes quantize(LN(y))
// with f32 statistics over the whole row.
//
// What bounds it on an H100. At the ViT-S serving shapes (M = B*197,
// K = 384 or 1536, N = 384..1536) each GEMM does 2*M*N*K int8 operations on
// M*K + K*N + M*N*(1..4) bytes: ~100-700 ops per byte, so the bound is the
// tensor cores (1,979 dense int8 TOP/s), not HBM (3.35 TB/s).
//
// Simple design (a first, correct kernel; wgmma/TMA/pipelining are later
// work): 128 threads = 2 x 2 warps; each k-step of 64 bytes stages an A tile
// [BM x 64] and a W tile [64 x 64] in shared memory, synchronously, and each
// warp issues mma.sync.m16n8k32.s8 on its (BM/2 x 32) sub-tile with int32
// accumulators in registers. The W tile is transposed on the way into shared
// memory (4x4 byte transposes with __byte_perm) so that a B fragment, four
// consecutive k of one column, is one 32-bit word; no pre-transposed copy of
// the weight exists. Rows are padded to 80 bytes (20 words), which makes the
// fragment reads free of bank conflicts. Ragged M and N are masked (the head
// has N = 10); K must be a multiple of 64 (the wrapper checks).
//
// LayerNorm needs whole rows, so RESID_LN_Q runs one block per BM = 32 rows
// that owns ALL N columns: it loops over the N/64 column tiles, keeps the f32
// y of its rows in shared memory (32 x N x 4 bytes: 48 KB at N = 384, 96 KB
// at N = 768), and computes the row statistics from there, one warp per row.

#include "common.cuh"

namespace {

constexpr int BK = 64;         // k bytes per shared-memory tile
constexpr int BKP = BK + 16;   // padded row stride in bytes (20 words)
constexpr int BN = 64;         // columns per tile
constexpr int THREADS = 128;   // 4 warps, 2 x 2
constexpr int BM_TILED = 64;   // rows per block, PLAIN / GELU_Q
constexpr int BM_ROWS = 32;    // rows per block, RESID_LN_Q

enum Epilogue { EPI_PLAIN = 0, EPI_GELU_Q = 1, EPI_RESID_LN_Q = 2 };

struct GemmParams {
  const int8_t* a;         // [M, K]
  const int8_t* w;         // [K, N]
  const int32_t* colsum;   // [N]
  const float* bias;       // [N] or null
  const float* wscale;     // [N] when ws_per_channel, else unused
  const void* residual;    // [M, N] (RESID_LN_Q)
  const float* gamma;      // [N] (RESID_LN_Q)
  const float* beta;       // [N] (RESID_LN_Q)
  void* y;                 // [M, N] float output (PLAIN, RESID_LN_Q)
  int8_t* q;               // [M, N] int8 output (GELU_Q, RESID_LN_Q)
  int M, N, K;
  int ws_per_channel;
  int act;                 // 0 tanh-GELU, 1 quick-GELU
  int w_vec;               // N % 4 == 0: W rows read as 32-bit words
  float ws0;               // per-tensor weight scale
  float s_x;               // input activation scale
  int z_s;                 // input zero-point - 128
  float inv_s, zp, qmax;   // output quantize grid
  float eps;
};

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

template <int BM>
__device__ __forceinline__ void load_a_tile(const GemmParams& p, uint8_t* As, int m0,
                                            int k0) {
  for (int c = threadIdx.x; c < BM * (BK / 16); c += THREADS) {
    const int r = c / (BK / 16), col = (c % (BK / 16)) * 16;
    const int gm = m0 + r;
    int4 v = make_int4(0, 0, 0, 0);
    if (gm < p.M) v = *reinterpret_cast<const int4*>(p.a + (size_t)gm * p.K + k0 + col);
    *reinterpret_cast<int4*>(As + r * BKP + col) = v;
  }
}

// W tile [64 k x 64 n] -> Bs[n][k]: each unit is a 4 x 4 byte block read as
// four row words and written as four column words.
__device__ __forceinline__ void load_w_tile(const GemmParams& p, uint8_t* Bs, int n0,
                                            int k0) {
  constexpr int NU = BN / 4;
  for (int u = threadIdx.x; u < (BK / 4) * NU; u += THREADS) {
    const int ku = u / NU, nu = u % NU;
    const int k = k0 + ku * 4, n = n0 + nu * 4;
    uint32_t r[4];
    if (p.w_vec && n + 3 < p.N) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const uint32_t*>(p.w + (size_t)(k + i) * p.N + n);
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
template <int BM>
__device__ __forceinline__ void gemm_tile(const GemmParams& p, uint8_t* As, uint8_t* Bs,
                                          int m0, int n0, int (&acc)[BM / 32][4][4]) {
  constexpr int MI = BM / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * (BM / 2), wn = (warp & 1) * (BN / 2);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    load_a_tile<BM>(p, As, m0, k0);
    load_w_tile(p, Bs, n0, k0);
    __syncthreads();
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
    __syncthreads();
  }
}

__device__ __forceinline__ float dequant(const GemmParams& p, int acc, int n) {
  const int a = acc - p.z_s * p.colsum[n];
  const float sw = __fmul_rn(p.s_x, p.ws_per_channel ? p.wscale[n] : p.ws0);
  float y = __fmul_rn(static_cast<float>(a), sw);
  if (p.bias != nullptr) y = __fadd_rn(y, p.bias[n]);
  return y;
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

// PLAIN and GELU_Q: one block per (64-row, 64-column) output tile
template <int EPI, typename OutT>
__global__ void __launch_bounds__(THREADS) gemm_tiled_kernel(GemmParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int BM = BM_TILED;
  uint8_t* As = smem;
  uint8_t* Bs = smem + BM * BKP;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[BM / 32][4][4];
  gemm_tile<BM>(p, As, Bs, m0, n0, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
        if (EPI == EPI_PLAIN) {
          static_cast<OutT*>(p.y)[o] = qvt::from_f32<OutT>(y);
        } else {
          p.q[o] = qvt::quantize_shifted(activation(y, p.act), p.inv_s, p.zp, p.qmax);
        }
      }
}

// RESID_LN_Q: one block per 32 rows, all N columns
template <typename OutT, typename ResT>
__global__ void __launch_bounds__(THREADS) gemm_resid_ln_kernel(GemmParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int BM = BM_ROWS;
  uint8_t* As = smem;
  uint8_t* Bs = smem + BM * BKP;
  float* Ys = reinterpret_cast<float*>(smem + (BM + BN) * BKP);
  const int m0 = blockIdx.x * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * (BM / 2), wn = (warp & 1) * (BN / 2);
  const ResT* res = static_cast<const ResT*>(p.residual);

  for (int n0 = 0; n0 < p.N; n0 += BN) {
    int acc[BM / 32][4][4];
    gemm_tile<BM>(p, As, Bs, m0, n0, acc);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int lr = wm + g + (r >= 2 ? 8 : 0);
        const int row = m0 + lr;
        const int col = n0 + wn + ni * 8 + 2 * t + (r & 1);
        if (row >= p.M || col >= p.N) continue;
        const size_t o = (size_t)row * p.N + col;
        const float y = __fadd_rn(dequant(p, acc[0][ni][r], col), qvt::to_f32(res[o]));
        Ys[lr * p.N + col] = y;
        static_cast<OutT*>(p.y)[o] = qvt::from_f32<OutT>(y);
      }
  }
  __syncthreads();

  for (int lr = warp; lr < BM; lr += THREADS / 32) {
    const int row = m0 + lr;
    if (row >= p.M) continue;
    const float* yr = Ys + lr * p.N;
    const float2 st = qvt::warp_row_stats([&](int c) { return yr[c]; }, p.N, p.eps);
    for (int c = lane; c < p.N; c += 32) {
      const float z = qvt::ln_affine(yr[c], st, p.gamma[c], p.beta[c]);
      p.q[(size_t)row * p.N + c] = qvt::quantize_shifted(z, p.inv_s, p.zp, p.qmax);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           const GemmParams& p) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t (0 = launched). Pointers are device pointers; the
// kernel allocates nothing and does not synchronise.
extern "C" int qvt_int8_gemm(const void* a, const void* w, const void* colsum,
                             const void* bias, const void* wscale, const void* residual,
                             const void* gamma, const void* beta, void* y, void* q,
                             int M, int N, int K, int epilogue, int out_bf16,
                             int res_bf16, int ws_per_channel, int act, float ws0,
                             float s_x, int z_s, float inv_s, float zp, float qmax,
                             float eps, void* stream) {
  GemmParams p;
  p.a = static_cast<const int8_t*>(a);
  p.w = static_cast<const int8_t*>(w);
  p.colsum = static_cast<const int32_t*>(colsum);
  p.bias = static_cast<const float*>(bias);
  p.wscale = static_cast<const float*>(wscale);
  p.residual = residual;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.y = y;
  p.q = static_cast<int8_t*>(q);
  p.M = M;
  p.N = N;
  p.K = K;
  p.ws_per_channel = ws_per_channel;
  p.act = act;
  p.w_vec = (N % 4 == 0) ? 1 : 0;
  p.ws0 = ws0;
  p.s_x = s_x;
  p.z_s = z_s;
  p.inv_s = inv_s;
  p.zp = zp;
  p.qmax = qmax;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;

  if (epilogue == EPI_RESID_LN_Q) {
    const dim3 grid((M + BM_ROWS - 1) / BM_ROWS);
    const size_t smem = (BM_ROWS + BN) * BKP + (size_t)BM_ROWS * N * sizeof(float);
    if (out_bf16 && res_bf16) return launch(gemm_resid_ln_kernel<bf16, bf16>, grid, smem, s, p);
    if (out_bf16) return launch(gemm_resid_ln_kernel<bf16, float>, grid, smem, s, p);
    if (res_bf16) return launch(gemm_resid_ln_kernel<float, bf16>, grid, smem, s, p);
    return launch(gemm_resid_ln_kernel<float, float>, grid, smem, s, p);
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM_TILED - 1) / BM_TILED);
  const size_t smem = (BM_TILED + BN) * BKP;
  if (epilogue == EPI_GELU_Q) return launch(gemm_tiled_kernel<EPI_GELU_Q, float>, grid, smem, s, p);
  if (epilogue != EPI_PLAIN) return static_cast<int>(cudaErrorInvalidValue);
  if (out_bf16) return launch(gemm_tiled_kernel<EPI_PLAIN, bf16>, grid, smem, s, p);
  return launch(gemm_tiled_kernel<EPI_PLAIN, float>, grid, smem, s, p);
}
