// Long-sequence multi-head attention with the output quantized to shifted
// int8, on the tensor cores, for sm_90a: the attention stage of K6, in both
// score forms.
//
// Replaces (TPU, Pallas): phase 2 of qat_vit_tpu/ops/long_block_kernel.py::
// _long_block_impl (run by _long_block_kernel and _long_model_kernel), the
// scores, softmax and p @ v of a q stripe followed by the `_q8` of o_scr:
// - qvt_attention_long_q_mma: scores of q (scaled by hd^-0.5 in bf16) and k
//   of the packed bf16 qkv;
// - qvt_attention_long_q8_mma: K6's int8_scores (the `i8` serving flag): q
//   and k come as shifted int8 on the qkv out_q grid (int8_gemm's PLAIN_Q8
//   epilogue writes them, [B, N, 2*H*hd]), and the score is
//   s_o^2 hd^-0.5 * (q8.k8 - z'(rowsum q8 + rowsum k8) + hd z'^2), z' =
//   z_o - 128, summed exactly in int32.
// The output is quantize(o) on the qkv out_q grid (inv_s, zp, qmax), into
// the packed int8 [B, N, H*hd] output at column h*hd.
//
// What bounds it on an H100. Per (image, head) the work is 4*N*N*hd
// operations (two products) on ~4*N*hd bytes: ~1,150 operations per byte
// at OWLv2's 2,305 tokens and hd 64, far above the card's ~295, so it is
// compute-bound and only the tensor cores come near the bound (989 TFLOP/s
// in bf16, 1,979 TOP/s in int8, against 67 TFLOP/s for f32 on the CUDA
// cores). This kernel does three products (the scores twice), 6*N*N*hd.
//
// Design: the layout of attention_long_mma.cu (K5a) with two passes in one
// launch, because JAX's kernel and the plain version round the NORMALISED
// p = e / sum(e) to bf16 before p @ v; an online softmax would round
// exp(s - m) instead and move ~30% of o's bf16 steps, which the int8 grid
// turns into flipped outputs.
// - one block per (128 query rows, head, image), 8 warps of 16 rows each,
//   at most 128 registers a thread at hd <= 64, so that two blocks fit an
//   SM; the q rows are staged once (scaled in bf16, or as int8) and each
//   warp keeps them as mma A fragments (ldmatrix);
// - pass 1 streams the K tiles (64 keys) and keeps each row's running max m
//   and sum l of exp2((s - m) log2e) in f32 (the online rescale of K5a);
//   pass 2 streams the K and V tiles, recomputes s, forms p = exp2((s - m)
//   log2e) * (1 / l), rounds p to bf16 and accumulates p @ v on
//   mma.sync.m16n8k16 in f32. The passes are one sequence of 2 * ceil(N /
//   64) tiles through one cp.async ring (3 stages at hd <= 64, 2 above;
//   pass 1 fills only the K slot of a stage), with one barrier per tile;
// - bf16 scores: mma.sync.m16n8k16 (bf16 in, f32 accumulate); int8 scores:
//   mma.sync.m16n8k32.s8 on the int8 q and k tiles (rows of hd bytes,
//   zero-filled to a multiple of 32), exact in int32; the q row sums are
//   taken once from the q fragments, each key's sum per tile from its k
//   fragments (dp4a, a quad reduction, a shuffle to the lanes whose score
//   columns hold the key), so the corrected score is the plain version's
//   bit for bit;
// - keys >= n_valid get -1e30 before the softmax; keys past N are
//   zero-filled (their sums are 0 and their scores masked);
// - hd is any multiple of 8 up to 128 (the bf16 dot zero-filled to a
//   multiple of 16, the int8 one to 32); only tiles live in shared memory,
//   so any N >= 1;
// - epilogue: quantize_shifted(o) with round-half-even, two bytes a lane.
//
// Roundings kept from the TPU kernel: q scaled in bf16; the normalised p
// rounded to bf16 for p @ v; f32 accumulators; masking at -1e30; the int8
// scores exact. Against the plain version
// (ops/long_attention.long_attention_qkv_plain(out_q=...),
// long_attention_q8_plain: index-order f32 sums, exp in f64) the sums of
// the bf16 score dot, of l and of p @ v run in the tensor cores' order, and
// ex2.approx replaces the f64 exp, so an o near an int8 rounding midpoint
// may land one step away: the card holds it to max |diff| 1 and >= 99.9%
// identical (chip_smoke.py, tests/test_torch_port_cuda.py).

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

using namespace qvt_mma;

constexpr int WARPS = 8;
constexpr int BN = 64;  // keys per tile
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // query rows per block

template <int HDP>
constexpr int MIN_BLOCKS = HDP <= 64 ? 512 / THREADS : 1;

template <int HDP>
constexpr int STAGES = HDP <= 64 ? 3 : 2;

// rows of the tiles: bf16 q, k, v of HDP + 8 elements; int8 q, k of HDP + 16
// bytes (an odd number of 16-byte chunks either way: conflict-free ldmatrix)
template <int HDP>
constexpr int ROW8 = HDP + 16;

template <int HDP, bool I8>
__host__ __device__ constexpr size_t qk_tile_bytes(int rows) {
  return I8 ? (size_t)rows * ROW8<HDP> : sizeof(bf16) * (size_t)rows * (HDP + 8);
}

template <int HDP, bool I8>
constexpr size_t smem_bytes() {  // q; K per stage; V per stage
  return qk_tile_bytes<HDP, I8>(BM) + STAGES<HDP> * qk_tile_bytes<HDP, I8>(BN) +
         sizeof(bf16) * (size_t)STAGES<HDP> * BN * (HDP + 8);
}

// 8-byte cp.async (.ca), zeros when !valid
__device__ __forceinline__ void cp_async8_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

// rows [r0, r0 + ROWS) of one head's hd int8 columns of a packed [*, ld]
// int8 tensor (src at row 0, column 0 of the head) into a [ROWS][ROW8] tile,
// zero-filled past hd up to a multiple of 32 and for rows >= rows_ok: 16-byte
// copies where the head's columns are 16-byte aligned (hd % 16 == 0), else
// 8-byte ones. Part of the caller's commit group.
template <int ROWS, int HDP, int THREADS_>
__device__ __forceinline__ void load_tile8(int8_t* tile, const int8_t* src, size_t ld, int r0,
                                           int rows_ok, int hd) {
  const int hd32 = (hd + 31) & ~31;
  if (hd % 16 == 0) {
    constexpr int CH = HDP / 16;
    const int nch = hd32 / 16, hch = hd / 16;
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS_) {
      const int r = i / CH, c = i % CH;
      if (c >= nch) continue;
      const bool ok = r0 + r < rows_ok && c < hch;
      cp_async16_zfill(tile + r * ROW8<HDP> + 16 * c,
                       ok ? src + (size_t)(r0 + r) * ld + 16 * c : src, ok);
    }
  } else {
    constexpr int CH = HDP / 8;
    const int nch = hd32 / 8, hch = hd / 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS_) {
      const int r = i / CH, c = i % CH;
      if (c >= nch) continue;
      const bool ok = r0 + r < rows_ok && c < hch;
      cp_async8_zfill(tile + r * ROW8<HDP> + 8 * c,
                      ok ? src + (size_t)(r0 + r) * ld + 8 * c : src, ok);
    }
  }
}

// c += a b (m16n8k32, int8 operands, int32 accumulators)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the sum of the four int8 bytes of a word
__device__ __forceinline__ int bytesum(uint32_t w, int acc) {
  return __dp4a(static_cast<int>(w), 0x01010101, acc);
}

// sum over the four lanes of a quad (lanes 4g .. 4g + 3)
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// An int8 [rows][ROW8] tile read as bf16 pairs: its 32-byte k-steps are the
// 16-element k-steps of a [rows][HDP/2 + 8] bf16 tile, so the bf16 ldmatrix
// fragment helpers give the m16n8k32.s8 fragments (a byte k-step of 32 is an
// element k-step of 16; a row of ROW8 bytes is HDP/2 + 8 elements).
template <int HDP>
__device__ __forceinline__ const bf16* as_pairs(const int8_t* p) {
  static_assert(ROW8<HDP> == 2 * (HDP / 2 + 8), "int8 rows must be bf16 rows of HDP/2");
  return reinterpret_cast<const bf16*>(p);
}

template <int HDP, bool I8>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<HDP>)
    long_attention_q_mma_kernel(const bf16* __restrict__ qkv, const int8_t* __restrict__ qk8,
                                int8_t* __restrict__ out, int N, int H, int hd, int n_valid,
                                float scale, int zq8, float inv_s, float zp, float qmax) {
  constexpr int SROW = HDP + 8;
  constexpr int KS = HDP / 16;   // bf16 k-steps of the score dot; 16-column pairs of o
  constexpr int KS8 = HDP / 32;  // int8 k-steps of the score dot
  constexpr int NS = STAGES<HDP>;
  constexpr int QKT = static_cast<int>(qk_tile_bytes<HDP, I8>(BN));  // a K tile's bytes
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const Qs = smem;                                   // [BM] rows of q
  uint8_t* const Ks = Qs + qk_tile_bytes<HDP, I8>(BM);        // [NS] K tiles
  bf16* const Vs = reinterpret_cast<bf16*>(Ks + NS * QKT);    // [NS][BN][SROW]
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd;
  const size_t ld = 3 * (size_t)D, ld8 = 2 * (size_t)D;
  const bf16* const img = qkv + (size_t)b * N * ld + h * hd;
  const int8_t* const img8 = I8 ? qk8 + (size_t)b * N * ld8 + h * hd : nullptr;
  const int hdp = (hd + 15) & ~15, hd32 = (hd + 31) & ~31;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = (N + BN - 1) / BN;  // key tiles per pass
  const int total = 2 * nt;          // pass p: tiles p nt .. (p + 1) nt - 1

  // tile t of the sequence into ring stage `stage`: its K tile, and in pass
  // 2 its V tile; one commit group
  auto load = [&](int t, int stage) {
    const int kt = t % nt;
    if constexpr (I8)
      load_tile8<BN, HDP, THREADS>(reinterpret_cast<int8_t*>(Ks + stage * QKT), img8 + D, ld8,
                                   kt * BN, N, hd);
    else
      load_tile<BN, HDP, THREADS>(reinterpret_cast<bf16*>(Ks + stage * QKT), img + D, ld,
                                  kt * BN, N, hd);
    if (t >= nt)
      load_tile<BN, HDP, THREADS>(Vs + stage * BN * SROW, img + 2 * D, ld, kt * BN, N, hd);
    cp_async_commit();
  };
  for (int t = 0; t < NS - 1; ++t) {  // the first tiles (empty groups past the last)
    if (t < total)
      load(t, t);
    else
      cp_async_commit();
  }
  if constexpr (I8) {  // the int8 q rows, synchronously (8 bytes at a time)
    int8_t* const Q8 = reinterpret_cast<int8_t*>(Qs);
    for (int i = threadIdx.x; i < BM * (HDP / 8); i += THREADS) {
      const int r = i / (HDP / 8), c = i % (HDP / 8);
      if (8 * c >= hd32) continue;
      uint2 w = make_uint2(0u, 0u);
      if (q0 + r < N && 8 * c < hd)
        w = *reinterpret_cast<const uint2*>(img8 + (size_t)(q0 + r) * ld8 + 8 * c);
      *reinterpret_cast<uint2*>(Q8 + r * ROW8<HDP> + 8 * c) = w;
    }
  } else {
    load_tile_scaled<BM, HDP, THREADS>(reinterpret_cast<bf16*>(Qs), img, ld, q0, N, hd, scale);
  }
  __syncthreads();

  // the warp's 16 q rows as A fragments (bf16: KS k-steps of 16; int8: KS8
  // k-steps of 32 bytes), and with int8 scores the rows' byte sums
  uint32_t qf[I8 ? KS8 : KS][4];
  int zrow[2] = {0, 0};  // int8: z' * (rowsum q8) - hd z'^2 of rows g, g + 8
  if constexpr (I8) {
    int rq[2] = {0, 0};
#pragma unroll
    for (int ks = 0; ks < KS8; ++ks) {
      if (32 * ks >= hd32) continue;
      frag_a<HDP / 2>(as_pairs<HDP>(reinterpret_cast<int8_t*>(Qs) + warp * 16 * ROW8<HDP>), ks,
                      qf[ks]);
      rq[0] = bytesum(qf[ks][2], bytesum(qf[ks][0], rq[0]));
      rq[1] = bytesum(qf[ks][3], bytesum(qf[ks][1], rq[1]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) zrow[r] = zq8 * quad_sum(rq[r]) - hd * zq8 * zq8;
  } else {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      if (16 * ks < hdp) frag_a<HDP>(reinterpret_cast<bf16*>(Qs) + warp * 16 * SROW, ks, qf[ks]);
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
    const int stage = t % NS, next = t + NS - 1;
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile t visible to every warp, and every warp done with tile t - 1
    if (next < total)  // into tile t - 1's stage
      load(next, next % NS);
    else
      cp_async_commit();
    const int pass = t / nt, k0 = (t - pass * nt) * BN;

    // ---- s: 16 rows x 64 keys per warp ----
    float s[BN / 8][4];
    if constexpr (I8) {
      const int8_t* const Kt = reinterpret_cast<const int8_t*>(Ks + stage * QKT);
      int si[BN / 8][4], rk[BN / 8];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        rk[j] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) si[j][e] = 0;
      }
#pragma unroll
      for (int ks = 0; ks < KS8; ++ks) {
        if (32 * ks >= hd32) continue;
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t kb[4];  // keys 16 np + g: kb[0], kb[1]; keys 16 np + 8 + g: kb[2], kb[3]
          frag_b<HDP / 2>(as_pairs<HDP>(Kt), 16 * np, ks, kb);
          mma_s8(si[2 * np], qf[ks], kb[0], kb[1]);
          mma_s8(si[2 * np + 1], qf[ks], kb[2], kb[3]);
          rk[2 * np] = bytesum(kb[1], bytesum(kb[0], rk[2 * np]));
          rk[2 * np + 1] = bytesum(kb[3], bytesum(kb[2], rk[2 * np + 1]));
        }
      }
      // rk[j] of quad g: the byte sum of key 8 j + g; the score columns of
      // lane (g, t) are keys 8 j + 2 t and 8 j + 2 t + 1
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int full = quad_sum(rk[j]);
        const int ka = __shfl_sync(0xffffffffu, full, 8 * (lane & 3));
        const int kb = __shfl_sync(0xffffffffu, full, 8 * (lane & 3) + 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = si[j][e] - zrow[e >> 1] - zq8 * ((e & 1) ? kb : ka);
          s[j][e] = __fmul_rn(static_cast<float>(c), scale);
        }
      }
    } else {
      const bf16* const Kt = reinterpret_cast<const bf16*>(Ks + stage * QKT);
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
    const bf16* const Vt = Vs + stage * BN * SROW;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
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
  cp_async_wait<0>();

  // ---- epilogue: o quantized to shifted int8 ----
  const int row0 = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= N) continue;
    int8_t* const orow = out + ((size_t)b * N + qi) * D + h * hd;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      if (c < hd) {
        const uint8_t lo = static_cast<uint8_t>(qvt::quantize_shifted(o[j][2 * r], inv_s, zp, qmax));
        const uint8_t hi =
            static_cast<uint8_t>(qvt::quantize_shifted(o[j][2 * r + 1], inv_s, zp, qmax));
        *reinterpret_cast<uint16_t*>(orow + c) = static_cast<uint16_t>(lo | (hi << 8));
      }
    }
  }
}

template <int HDP, bool I8>
int launch(const void* qkv, const void* qk8, void* out, int B, int N, int H, int hd, int n_valid,
           float scale, int zq8, float inv_s, float zp, float qmax, cudaStream_t stream) {
  auto kernel = long_attention_q_mma_kernel<HDP, I8>;
  const size_t smem = smem_bytes<HDP, I8>();
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((N + BM - 1) / BM, H, B), THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const int8_t*>(qk8), static_cast<int8_t*>(out),
      N, H, hd, n_valid, scale, zq8, inv_s, zp, qmax);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int N, int hd, int n_valid) {
  return hd <= 0 || hd > 128 || hd % 8 || N <= 0 || n_valid <= 0 || n_valid > N;
}

}  // namespace

// out: shifted int8 [B, N, H*hd] on (inv_s, zp, qmax) of the packed bf16 qkv
// [B, N, 3*H*hd]; scale: hd^-0.5 in bf16; hd a multiple of 8, at most 128;
// any N >= 1
extern "C" int qvt_attention_long_q_mma(const void* qkv, void* out, int B, int N, int H, int hd,
                                        int n_valid, float scale, float inv_s, float zp,
                                        float qmax, void* stream) {
  if (bad_shape(N, hd, n_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch<64, false>(qkv, nullptr, out, B, N, H, hd, n_valid, scale, 0, inv_s, zp, qmax, st);
  return launch<128, false>(qkv, nullptr, out, B, N, H, hd, n_valid, scale, 0, inv_s, zp, qmax, st);
}

// the int8-score form: q and k from qk8 [B, N, 2*H*hd] (shifted int8 on the
// qkv out_q grid, zero point zq8 = z_o - 128), v from the bf16 qkv; sscale =
// s_o * s_o * hd^-0.5 in f32; out shifted int8 on (inv_s, zp, qmax)
extern "C" int qvt_attention_long_q8_mma(const void* qk8, const void* qkv, void* out, int B,
                                         int N, int H, int hd, int n_valid, float sscale,
                                         int zq8, float inv_s, float zp, float qmax,
                                         void* stream) {
  if (bad_shape(N, hd, n_valid)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch<64, true>(qkv, qk8, out, B, N, H, hd, n_valid, sscale, zq8, inv_s, zp, qmax, st);
  return launch<128, true>(qkv, qk8, out, B, N, H, hd, n_valid, sscale, zq8, inv_s, zp, qmax, st);
}
