// Short-sequence multi-head attention over the packed bf16 qkv on the tensor
// cores, for sm_90a, in three forms:
//
// - qvt_attention_q_mma: output quantized to shifted int8 (K3).
//   Replaces (TPU, Pallas): qat_vit_tpu/ops/flash_attention.py::
//   _fused_attention_kernel with quantize=True, and the attention stage of
//   qat_vit_tpu/ops/block_kernel.py::_block_tile_body (K4's chain).
// - qvt_attention_fwd_mma: output in bf16, optionally with the qkv
//   activation fake-quant applied to q, k and v as they are staged (kernel A,
//   K1's forward). Replaces: _fused_attention_kernel with quantize=False,
//   with and without in_fq, as qat_vit_tpu/ops/flash_attention_train.py's
//   attention_train and attention_train_fq launch it for bf16 qkv.
// - qvt_flash_attention_mma: output in bf16, the f32 score scaled by
//   hd^-0.5 AFTER the dot (K8). Replaces: qat_vit_tpu/ops/flash_attention.py::
//   _attention_kernel for bf16 qkv (attn_impl="pallas"), at any N.
// (The f32 kernel A and K8 run on the CUDA cores in attention_f32.cu.)
//
// What bounds it on an H100. Per (image, head) the work is 4*N*N*hd
// operations on ~4*N*hd bytes: at ViT's 197 tokens and hd 64 ~200
// operations per byte, under the card's ~295 in bf16, so the bound is the
// bytes (0.005 ms for [32, 197, 1152]), and only the tensor cores keep the
// operations under it (989 TFLOP/s in bf16 against 67 TFLOP/s for f32 on
// the CUDA cores). This kernel does three products (the scores twice),
// 6*N*N*hd.
//
// Design: the two passes of attention_long_q_mma.cu (K6a), laid out for a
// short sequence. JAX's kernel and the plain versions round the NORMALISED
// p = e / sum(e) to bf16 before p @ v; an online softmax would round
// exp(s - m) instead and move ~30% of o's bf16 steps, so both forms keep
// two passes.
// - one block per (128 query rows, head, image), 8 warps of 16 rows each, at
//   most 128 registers a thread at hd <= 64: at ViT-S batch 32, 384 blocks
//   of ~60 KB shared memory, three resident per SM (one wave); the layout
//   port_scripts/k3_variants.py timed fastest against 32 and 64 rows and
//   the streamed form (PERF.md);
// - K and V of the head resident: K (rows rounded up to 16, zero-filled
//   past N, rows of HDP + 8 bf16 for conflict-free ldmatrix) is copied
//   once by cp.async together with the block's q rows, which are staged in
//   V's place; each warp keeps its 16 q rows as mma A fragments; then V is
//   copied over them while pass 1 runs on K. Both passes read K from
//   shared memory, and nothing goes through a ring. Where K and V of one
//   head do not fit whole (hd 128 or hd < 64 near the gate's N), the same
//   passes stream 64-key tiles through K6a's cp.async ring (3 stages at hd
//   <= 64, 2 above);
// - with in_fq every staged element of q, k and v is fake-quantized in
//   place by the thread that copied it (f32, round half to even, clip,
//   back to bf16), with (scale, zero point) read from the device tensor qs;
//   q is then scaled by hd^-0.5 in bf16 (K8: q stays as it is, and each
//   f32 score is multiplied by the f32 hd^-0.5 as it leaves the dot, before
//   the mask). The zero fill is never touched;
// - pass 1 computes each row's running max m and sum l of exp2((s - m)
//   log2e) in f32 over 64-key tiles (the online rescale of K5a); pass 2
//   recomputes s, forms p = exp2((s - m) log2e) * (1 / l), rounds p to bf16
//   and accumulates p @ v, both products on mma.sync.m16n8k16 (bf16 in, f32
//   accumulate); key groups of 16 past N are skipped;
// - keys >= n_valid get -1e30; hd is any multiple of 8 up to 128 (the dot
//   zero-filled to a multiple of 16); any N >= 1;
// - epilogue: quantize_shifted(o) with round-half-even (K3) or o rounded to
//   bf16 (kernel A, K8), two values a lane, into the packed [B, N, H*hd]
//   output at column h*hd.
//
// Roundings kept from the TPU kernels: the fake-quant; q scaled in bf16
// (K8: the f32 score scaled in f32); the normalised p rounded to bf16 for
// p @ v; f32 accumulators; masking at -1e30. Against the plain versions
// (ops/flash_attention.fused_attention_qkv_plain, attention_fwd_plain,
// flash_attention_qkv_plain: index-order f32 sums, exp in f64) the sums of
// the score dot, of l and of p @ v run in the tensor cores' order and
// ex2.approx replaces the f64 exp, so K3's int8 output is held to max
// |diff| 1 and >= 99.9% identical, and the bf16 output of kernel A and K8
// to 2^-7 (1 + |plain|) and to twice the plain version's distance from the
// f64 math (chip_smoke.py, tests/test_torch_port_cuda.py).

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

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

// SCALE_AFTER (K8): q enters the dot unscaled and the f32 score is scaled
template <int HDP, bool QOUT, bool IN_FQ, bool RESIDENT, bool SCALE_AFTER>
__global__ void __launch_bounds__(THREADS, (MIN_BLOCKS<HDP, RESIDENT>))
    attention_q_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ qs,
                           void* __restrict__ out, int N, int H, int hd, int n_valid, float scale,
                           float inv_s, float zp, float qmax, float fq_min, float fq_max) {
  constexpr int S = SROW<HDP>;
  constexpr int KS = HDP / 16;  // k-steps of the score dot; 16-column pairs of o
  constexpr int NS = STAGES<HDP>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* const smem = reinterpret_cast<bf16*>(smem_raw);
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
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

template <int HDP, bool QOUT, bool IN_FQ, bool RESIDENT, bool SCALE_AFTER>
int go(size_t smem, const void* qkv, const void* qs, void* out, int B, int N, int H, int hd,
       int n_valid, float scale, float inv_s, float zp, float qmax, float fq_min, float fq_max,
       cudaStream_t stream) {
  auto kernel = attention_q_mma_kernel<HDP, QOUT, IN_FQ, RESIDENT, SCALE_AFTER>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((N + BM - 1) / BM, H, B), THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(qs), out, N, H, hd, n_valid, scale,
      inv_s, zp, qmax, fq_min, fq_max);
  return static_cast<int>(cudaGetLastError());
}

// K and V resident where one head's fit the shared memory, else streamed
template <int HDP, bool QOUT, bool IN_FQ, bool SCALE_AFTER>
int launch(const void* qkv, const void* qs, void* out, int B, int N, int H, int hd, int n_valid,
           float scale, float inv_s, float zp, float qmax, float fq_min, float fq_max,
           cudaStream_t stream) {
  const size_t resident = resident_smem<HDP>(N);
  if (resident <= SMEM_MAX)
    return go<HDP, QOUT, IN_FQ, true, SCALE_AFTER>(resident, qkv, qs, out, B, N, H, hd, n_valid,
                                                   scale, inv_s, zp, qmax, fq_min, fq_max,
                                                   stream);
  return go<HDP, QOUT, IN_FQ, false, SCALE_AFTER>(stream_smem<HDP>(), qkv, qs, out, B, N, H, hd,
                                                  n_valid, scale, inv_s, zp, qmax, fq_min, fq_max,
                                                  stream);
}

template <bool QOUT, bool IN_FQ, bool SCALE_AFTER = false>
int dispatch(const void* qkv, const void* qs, void* out, int B, int N, int H, int hd, int n_valid,
             float scale, float inv_s, float zp, float qmax, float fq_min, float fq_max,
             void* stream) {
  if (hd <= 0 || hd > 128 || hd % 8 || N <= 0 || n_valid <= 0 || n_valid > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch<64, QOUT, IN_FQ, SCALE_AFTER>(qkv, qs, out, B, N, H, hd, n_valid, scale, inv_s,
                                                zp, qmax, fq_min, fq_max, st);
  return launch<128, QOUT, IN_FQ, SCALE_AFTER>(qkv, qs, out, B, N, H, hd, n_valid, scale, inv_s,
                                               zp, qmax, fq_min, fq_max, st);
}

}  // namespace

// K3: out shifted int8 [B, N, H*hd] on (inv_s, zp, qmax) of the packed bf16
// qkv [B, N, 3*H*hd]; scale: hd^-0.5 in bf16; hd a multiple of 8, at most
// 128; any N >= 1
extern "C" int qvt_attention_q_mma(const void* qkv, void* out, int B, int N, int H, int hd,
                                   int n_valid, float scale, float inv_s, float zp, float qmax,
                                   void* stream) {
  return dispatch<true, false>(qkv, nullptr, out, B, N, H, hd, n_valid, scale, inv_s, zp, qmax,
                               0.0f, 0.0f, stream);
}

// kernel A in bf16: out bf16 [B, N, H*hd]; in_fq != 0 fake-quantizes q, k, v
// with (qs[0], qs[1], fq_min, fq_max) first; scale: hd^-0.5 in bf16
extern "C" int qvt_attention_fwd_mma(const void* qkv, const void* qs, void* out, int B, int N,
                                     int H, int hd, int n_valid, float scale, int in_fq,
                                     float fq_min, float fq_max, void* stream) {
  if (in_fq)
    return dispatch<false, true>(qkv, qs, out, B, N, H, hd, n_valid, scale, 0.0f, 0.0f, 0.0f,
                                 fq_min, fq_max, stream);
  return dispatch<false, false>(qkv, nullptr, out, B, N, H, hd, n_valid, scale, 0.0f, 0.0f, 0.0f,
                                0.0f, 0.0f, stream);
}

// K8 in bf16: out bf16 [B, N, H*hd]; scale: the f32 hd^-0.5, applied to the
// f32 score after the dot
extern "C" int qvt_flash_attention_mma(const void* qkv, void* out, int B, int N, int H, int hd,
                                       int n_valid, float scale, void* stream) {
  return dispatch<false, false, true>(qkv, nullptr, out, B, N, H, hd, n_valid, scale, 0.0f, 0.0f,
                                      0.0f, 0.0f, 0.0f, stream);
}
