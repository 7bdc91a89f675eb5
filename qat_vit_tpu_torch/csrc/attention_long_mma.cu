// Long-sequence multi-head attention over the packed bf16 qkv on the tensor
// cores, for sm_90a: a streaming online-softmax forward (K5a in bf16).
//
// Replaces (TPU, Pallas): qat_vit_tpu/ops/long_attention.py::
// _long_attention_kernel, for a bf16 qkv. The f32 form and K6's two int8
// forms stay on csrc/attention_long.cu.
//
// What bounds it on an H100. Per (image, head) the work is 4*N*N*hd
// operations (two products) on 4*N*hd*2 bytes: ~1,150 operations per byte
// at OWLv2's 2,305 tokens and hd 64, far above the card's ~295, so it is
// compute-bound, and only the tensor cores (989 TFLOP/s in bf16 against 67
// for f32 on the CUDA cores) come near the bound. Their products sum in the
// hardware's own order, so this kernel is held to a tolerance against the
// plain version (ops/long_attention.long_attention_qkv_plain), not to
// identity.
//
// Design, FlashAttention-2 on mma.sync:
// - one block per (128 query rows, head, image), 8 warps of 16 rows each
//   (2,736 blocks at OWLv2's batch 16), at most 128 registers a thread at
//   hd <= 64, so that two blocks fit an SM;
// - the block stages its q rows scaled by hd^-0.5 IN bf16 (as JAX does)
//   and each warp keeps its rows as mma A fragments (ldmatrix);
// - K and V stream in tiles of 64 keys (9 KB each at hd 64) through three
//   cp.async stages at hd <= 64, two above; keys past N are zero-filled,
//   and keys >= n_valid get -1e30 before the softmax;
// - S = Q K^T on mma.sync.m16n8k16 (bf16 in, f32 accumulate); the running
//   row max m and row sum l stay in f32 registers; P = exp2(S log2e -
//   m log2e) is rounded to bf16 in registers and fed back as the A operand
//   of P V (V's fragments through ldmatrix.trans); earlier sums are
//   rescaled by exp2((m_old - m_new) log2e). No score row sits in shared
//   memory, so any N works, and shared memory holds only the tiles (72 KB
//   a block at hd <= 64, 104 KB up to hd 128: two blocks per SM);
// - hd is any multiple of 8 up to 128; the dot dimension is zero-filled
//   up to a multiple of 16 in shared memory (hd 72 runs as 80);
// - epilogue: o / l rounded to bf16 into the packed [B, N, H*hd] output at
//   column h*hd, and, when `lse` is not null, the row's log-sum-exp m +
//   log(l) as f32 [B, H, N] (the backward's statistics).
//
// Roundings kept from the TPU kernel: q scaled in bf16 before the dot; p
// rounded to bf16 for P V; f32 accumulators; masking at -1e30. Given up:
// index-ordered sums, the f64 exp and division of the plain version, and
// the rounding of the normalised p (this kernel rounds exp(s - m) and
// divides once at the end).
//
// Later step: wgmma with TMA-fed tiles and a producer warp, which mma.sync
// cannot reach (this kernel runs at ~2x SDPA's time; PERF.md section 6).

#include "mma_tile.cuh"

namespace {

using namespace qvt_mma;

constexpr int WARPS = 8;
constexpr int BN = 64;  // keys per tile
constexpr int THREADS = 32 * WARPS;

constexpr int BM = 16 * WARPS;  // query rows per block

// blocks per SM that the register budget must allow: 512 threads (<= 128
// registers each) at hd <= 64; above, the compiler's choice
template <int HDP>
constexpr int MIN_BLOCKS = HDP <= 64 ? 512 / THREADS : 1;

// cp.async stages of the K and V tiles: three at hd <= 64 (72 KB a block),
// two above (104 KB, so that two blocks still fit an SM)
template <int HDP>
constexpr int STAGES = HDP <= 64 ? 3 : 2;

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (size_t)(BM + 2 * STAGES<HDP> * BN) * (HDP + 8);  // q; K, V per stage
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<HDP>)
    long_attention_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                              float* __restrict__ lse, int N, int H, int hd, int n_valid,
                              float scale) {
  constexpr int SROW = HDP + 8;
  constexpr int KS = HDP / 16;  // k-steps of the score dot, 16-column pairs of o
  constexpr int NS = STAGES<HDP>;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* const Qs = reinterpret_cast<bf16*>(smem);    // [BM][SROW]
  bf16* const Ks = Qs + BM * SROW;                   // [NS][BN][SROW]
  bf16* const Vs = Ks + NS * BN * SROW;              // [NS][BN][SROW]
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd;
  const size_t ld = 3 * (size_t)D;
  const bf16* const img = qkv + (size_t)b * N * ld + h * hd;
  const int hdp = (hd + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (N + BN - 1) / BN;

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
  load_tile_scaled<BM, HDP, THREADS>(Qs, img, ld, q0, N, hd, scale);
  __syncthreads();

  uint32_t qf[KS][4];  // the warp's 16 rows
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    if (16 * ks < hdp) frag_a<HDP>(Qs + warp * 16 * SROW, ks, qf[ks]);

  float o[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};  // rows g and g + 8

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t % NS, next = t + NS - 1;
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile t visible to every warp, and every warp done with tile t - 1
    if (next < ntiles)  // into tile t - 1's stage
      load_kv(next, next % NS);
    else
      cp_async_commit();
    const bf16* const Kt = Ks + stage * BN * SROW;
    const bf16* const Vt = Vs + stage * BN * SROW;

    // ---- S = Q K^T, 16 rows x 64 keys per warp ----
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
        uint32_t kb[4];
        frag_b<HDP>(Kt, 16 * np, ks, kb);
        mma(s[2 * np], qf[ks], kb[0], kb[1]);
        mma(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // ---- online softmax ----
    const int k0 = t * BN;
    if (k0 + BN > n_valid) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * (lane & 3) + (e & 1) >= n_valid) s[j][e] = -1e30f;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float ml[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = ex2((m[r] - mx[r]) * LOG2E);
      m[r] = mx[r];
      ml[r] = mx[r] * LOG2E;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < 2 * KS; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], LOG2E, -ml[e >> 1]));
        rs[e >> 1] += s[j][e];
      }
    l[0] += rs[0];
    l[1] += rs[1];

    // ---- o += P V, P rounded to bf16 ----
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
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

  // ---- epilogue: o / l in bf16, and the log-sum-exp ----
  const int row0 = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.0f / lr;
    const int qi = row0 + 8 * r;
    if (qi >= N) continue;
    bf16* const orow = out + ((size_t)b * N + qi) * D + h * hd;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      if (c < hd)
        *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
    if (lse != nullptr && (lane & 3) == 0) lse[((size_t)b * H + h) * N + qi] = m[r] + logf(lr);
  }
}

template <int HDP>
int launch(const void* qkv, void* out, void* lse, int B, int N, int H, int hd, int n_valid,
           float scale, cudaStream_t stream) {
  auto kernel = long_attention_mma_kernel<HDP>;
  const size_t smem = smem_bytes<HDP>();
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((N + BM - 1) / BM, H, B), THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), static_cast<float*>(lse), N, H, hd,
      n_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [B, N, H*hd] bf16 of the packed bf16 qkv [B, N, 3*H*hd]; lse: f32
// [B, H, N] log-sum-exp of each row's scores, or null (not written); scale:
// hd^-0.5 in bf16; hd a multiple of 8, at most 128; any N >= 1
extern "C" int qvt_attention_long_mma(const void* qkv, void* out, void* lse, int B, int N, int H,
                                      int hd, int n_valid, float scale, void* stream) {
  if (hd <= 0 || hd > 128 || hd % 8 || N <= 0 || n_valid <= 0 || n_valid > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch<64>(qkv, out, lse, B, N, H, hd, n_valid, scale, st);
  return launch<128>(qkv, out, lse, B, N, H, hd, n_valid, scale, st);
}
