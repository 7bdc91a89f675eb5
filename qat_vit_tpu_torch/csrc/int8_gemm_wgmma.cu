// int8 x int8 -> int32 GEMM on Hopper's TMA and wgmma, with the PLAIN,
// PLAIN_Q8 and GELU_Q epilogues, for sm_90a (qvt_int8_gemm), and the fused
// quantize -> int8 GEMM -> dequantize of a float x (qvt_quantize_gemm).
//
// Replaces (TPU, Pallas):
//   qat_vit_tpu/ops/fused_serve.py::_plain_kernel       (K2a)  -> EPI_PLAIN
//   qat_vit_tpu/ops/long_block_kernel.py::_long_block_impl phase 1 with
//     int8_scores (K6's qkv GEMM + the q/k requantize)           -> EPI_PLAIN_Q8
//   qat_vit_tpu/ops/fused_serve.py::_gelu_q_kernel      (K2b)  -> EPI_GELU_Q
//   qat_vit_tpu/ops/pallas_gemm.py::_kernel             (K7)   -> qvt_quantize_gemm
// and the qkv, fc1, patch-embed and head GEMMs of K4's and K6's chains.
// (RESID_LN_Q (K2c) stays in int8_gemm.cu; K9 in megablock.cu.)
//
// What bounds it on an H100. y = (A @ W - z_s colsum) (s_x w_scale) + bias
// with A [M, K] shifted int8 and W int8: 2 M N K int8 operations on
// M K + K N + M N (1..6) bytes. At ViT-S batch 256 (M 50,432) fc1 [.. x
// 384] @ [384 x 1536] -> int8 is 59.5 G operations (0.030 ms at 1,979
// TOP/s) on 97 MB (0.029 ms at 3.35 TB/s); qkv -> bf16 moves 136 MB (0.041
// ms): both near the ridge, so the kernel has to keep the tensor cores fed
// AND write its outputs at the memory's rate.
//
// Design (Hopper's producer / consumer form):
// - W is read packed k-contiguous, [N, K] (layer["w_int8_t"], made once by
//   serve/int8_vit.export_to_device): wgmma takes 8-bit operands K-major
//   only. A [M, K] is K-major as it is.
// - One producer warp (one thread) starts TMA copies of [64 CONS x 128 B] A
//   tiles and [128 x 128 B] W tiles, with the 128-byte swizzle, into a ring
//   of STAGES stages guarded by mbarriers (full: the copy's bytes landed;
//   empty: every consumer warp is done with the stage). TMA's out-of-bounds
//   zero fill covers ragged M, ragged N (the head's 10, OWLv2's 1728) and the
//   K tail (K a multiple of 16: the tensor map's row stride).
// - CONS consumer warpgroups: each runs wgmma.mma_async m64n128k32 s32.s8.s8
//   on its 64 rows of the stage, int32 sums in registers, exact in any order.
// - Persistent blocks: one per SM (at most), walking the output tiles in
//   row-major tile order (the blocks in flight share A rows in L2), so the
//   producer loads the next tile while the consumers run this one's
//   epilogue: K is 384-768 on the main paths, 3-6 k-steps, and the
//   epilogue is a large share of a tile.
// - Epilogue: the tile's per-column constants (colsum, s_x w_scale, bias)
//   are staged in shared memory; the arithmetic is gemm_tile.cuh's
//   dequant_value, activation and quantize_shifted in the same order (so
//   the outputs are bit-identical to the plain versions,
//   ops/fused_serve.int8_dense*_plain, and to K9's qkv and fc1 stages,
//   which run the same loops: int8_gemm_wgmma.cuh); each warpgroup writes
//   its outputs into a padded shared-memory tile and then copies
//   whole 16-byte row segments to the output (element stores only at a
//   ragged edge or an unaligned row pitch). GELU_Q's exact tanh / sigmoid on the CUDA cores,
//   not the products, bound it: more consumer warps per SM, the activation
//   chosen at compile time (no branch per element) and each column pair's
//   constants read once for both of a thread's rows shorten it.
// - Sizes, chosen by port_scripts/k2ab_variants.py on an H100 (PERF.md):
//   W_BN 128 columns; 4 consumer warpgroups (256-row tiles, 96 registers)
//   with 3 stages of 48 KB where the output staging fits (PLAIN bf16,
//   GELU_Q), 2 stages for PLAIN_Q8, else 2 warpgroups (128-row tiles) with
//   4 stages of 32 KB (PLAIN f32).
//
// K7 reads x as f32 or bf16 and quantizes it on x's grid first. At the
// exact path's batch-32 shapes (M 6,304, K 384-1,536, N 384-1,536, f32
// out) it moves M K (2..4) + M N 4 bytes for 2 M N K int8 operations:
// bound by the bytes (0.004-0.015 ms at 3.35 TB/s), so x is read once and
// quantized once per strip of 64 rows, as the TPU kernel quantizes each x
// tile once for the whole [K, N] panel (its grid runs over M only), and the
// f32 outputs go straight from the accumulators to memory (a warp's store
// fills whole 32-byte sectors), with no staging tile. Its design is the
// block of code headed "K7" below.

#include <algorithm>

#include "int8_gemm_wgmma.cuh"

namespace {

using namespace qvt;
using namespace qvt::gemm;
using namespace qvt_wgmma;

// ACT: GELU_Q's activation (0 tanh-GELU, 1 quick-GELU), a template argument so
// that no element's epilogue branches on it
template <int EPI, typename OutT, int CONS, int STAGES, int ACT>
__global__ void __launch_bounds__(Cfg<CONS, STAGES>::THREADS, 1)
    int8_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_w, const GemmParams p) {
  using C = Cfg<CONS, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const ring = smem;
  uint8_t* const staging = ring + STAGES * C::STAGE_BYTES;
  uint8_t* const consts = staging + CONS * staging_bytes<EPI, OutT>();
  uint64_t* const full = reinterpret_cast<uint64_t*>(consts + CONS * 3 * 4 * W_BN);
  uint64_t* const empty = full + STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONS);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Ring r;
  if (warp == 4 * CONS) {  // the producer warp: one thread starts the copies
    if (lane == 0)
      wgmma_produce<CONS, STAGES>(&tma_a, &tma_w, ring, full, empty, p.M, p.N, p.K, blockIdx.x,
                                  gridDim.x, r);
    return;
  }
  wgmma_consume<EPI, OutT, CONS, STAGES, ACT>(p, ring, staging, consts, full, empty, blockIdx.x,
                                              gridDim.x, r);
}

// ---- K7: x quantized into a shared-memory strip, then int8 wgmma ----
//
// TMA copies bytes as they are, so the quantize cannot ride on the copy:
// the consumer threads load a strip of Q_ROWS rows of x (f32 or bf16, 16
// values a thread at a time), quantize it with quantize_shifted on x's grid
// and write it as int8, K-major in 128-byte rows with the 128-byte swizzle
// (the layout TMA would have written), then fence it into the async proxy.
// The strip stays while the block sweeps the N tiles of its units (a unit:
// the strip's rows x Q_BN columns, one 128-column tile per consumer
// warpgroup, all on the strip as wgmma's A); W [N, K] streams through a
// TMA ring of Q_BN x 128-byte stages that the producer fills from the first
// cycle, while the consumers quantize. Three warpgroups (12 warps) hide
// more of the latency of the quantize's loads and of the epilogue than two
// did, and 384 columns tile ViT's N of 384, 1,152 and 1,536 with no idle
// warpgroup (port_scripts/k7_variants.py). A K past Q_MAX_CHUNK is held in
// chunks, re-quantized for each unit. Persistent blocks, min(units, SMs) of
// them, take contiguous runs of units in strip-major order, so a strip is
// quantized once by each block whose run crosses it (whole strips per
// block measured no faster: port_scripts/k7_variants.py, strips).
constexpr int Q_ROWS = 64;                  // rows of a strip: one wgmma m64
constexpr int Q_CONS = 3;                   // consumer warpgroups, a 128-column tile each
constexpr int Q_BN = Q_CONS * W_BN;         // columns of a unit
constexpr int Q_THREADS = 128 * Q_CONS + 32;
constexpr int Q_KT_BYTES = Q_ROWS * W_BK;   // one k-step of the strip
constexpr int Q_STAGE_BYTES = Q_BN * W_BK;  // one k-step of W
constexpr int Q_MAX_CHUNK = 1536;           // k bytes of the strip held at once (96 KB)
constexpr int Q_MAX_STAGES = 4;
constexpr int Q_LOADS = 8;                  // 16-byte loads of x a thread keeps in flight

__host__ __device__ constexpr size_t q_smem_bytes(int chunk_k, int stages) {
  return 1024 /* alignment slack */ + (size_t)Q_ROWS * chunk_k + (size_t)stages * Q_STAGE_BYTES +
         (size_t)Q_CONS * 3 * 4 * W_BN + 2 * 8 * (size_t)stages;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * Q_CONS) : "memory");
}

// rows [m0, m0 + Q_ROWS) x k [kb0, kb0 + kl) of x, quantized into the strip
// (kl a multiple of W_BK); rows past M and k past K are written as zeros
template <typename XT>
__device__ __forceinline__ void quantize_strip(const GemmParams& p, uint8_t* strip, int m0,
                                               int kb0, int kl, int ctid) {
  constexpr int V = sizeof(XT);             // 16-byte words per 16-value chunk
  constexpr int U = Q_LOADS / V;            // chunks a thread loads before it stores
  const int cpr = kl / 16, total = Q_ROWS * cpr;
  const XT* const x = static_cast<const XT*>(p.a);
  for (int base = ctid; base < total; base += 128 * Q_CONS * U) {
    uint4 raw[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + 128 * Q_CONS * u, r = idx / cpr, k = kb0 + 16 * (idx % cpr);
      const bool ok = idx < total && m0 + r < p.M && k < p.K;
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * p.K + k);
#pragma unroll
      for (int v = 0; v < V; ++v) raw[u][v] = ok ? __ldg(src + v) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + 128 * Q_CONS * u;
      if (idx >= total) break;
      const int r = idx / cpr, c = idx % cpr, k = kb0 + 16 * c;
      uint32_t w[4] = {0, 0, 0, 0};
      if (m0 + r < p.M && k < p.K) {
        float f[16];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float h[16 / V];
          unpack_chunk<XT>(raw[u][v], h);
#pragma unroll
          for (int e = 0; e < 16 / V; ++e) f[v * (16 / V) + e] = h[e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[i] |= static_cast<uint32_t>(static_cast<uint8_t>(
                        quantize_shifted(f[4 * i + j], p.a_inv_s, p.a_zp, p.a_qmax)))
                    << (8 * j);
      }
      // k-step c / 8 of the strip, row r, 16-byte chunk c % 8 swizzled by r % 8
      *reinterpret_cast<uint4*>(strip + (c >> 3) * Q_KT_BYTES + r * W_BK +
                                (((c & 7) ^ (r & 7)) << 4)) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ void store_out(float* y, float a, float b, bool pair) {
  if (pair)
    *reinterpret_cast<float2*>(y) = make_float2(a, b);
  else
    y[0] = a;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* y, float a, float b, bool pair) {
  if (pair)
    *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
  else
    y[0] = __float2bfloat16_rn(a);
}

template <typename XT, typename OutT>
__global__ void __launch_bounds__(Q_THREADS, 1)
    quantize_gemm_kernel(const __grid_constant__ CUtensorMap tma_w, const GemmParams p,
                         int chunk_k, int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const strip = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const ring = strip + Q_ROWS * chunk_k;
  uint8_t* const consts = ring + stages * Q_STAGE_BYTES;
  uint64_t* const full = reinterpret_cast<uint64_t*>(consts + Q_CONS * 3 * 4 * W_BN);
  uint64_t* const empty = full + stages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_strip = (p.N + Q_BN - 1) / Q_BN;  // units of a strip
  const int units = (p.M + Q_ROWS - 1) / Q_ROWS * per_strip;
  const int u0 = static_cast<int>((long long)blockIdx.x * units / gridDim.x);
  const int u1 = static_cast<int>((long long)(blockIdx.x + 1) * units / gridDim.x);
  const int nk = (p.K + W_BK - 1) / W_BK, ck = chunk_k / W_BK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * Q_CONS);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * Q_CONS) {  // the producer warp: one thread streams W
    if (lane != 0) return;
    int stage = 0, phase = 0;
    for (int u = u0; u < u1; ++u) {
      const int n0 = (u % per_strip) * Q_BN;
      const int tiles = min(Q_CONS, (p.N - n0 + W_BN - 1) / W_BN);  // tiles not past N
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], tiles * W_BN * W_BK);
        for (int c = 0; c < tiles; ++c)
          tma_load(ring + stage * Q_STAGE_BYTES + c * W_BN * W_BK, &tma_w, &full[stage],
                   kt * W_BK, n0 + c * W_BN);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: its 128-column tile of each unit
  const int wg = warp >> 2, wtid = tid & 127, wwarp = warp & 3;
  int* const Cs = reinterpret_cast<int*>(consts + wg * 3 * 4 * W_BN);
  float* const Sw = reinterpret_cast<float*>(Cs + W_BN);
  float* const Bi = Sw + W_BN;
  const bool has_bias = p.bias != nullptr;
  const int g = lane >> 2, t4 = lane & 3;
  OutT* const y = static_cast<OutT*>(p.y);
  int stage = 0, phase = 0, held = -1;  // held: the strip in shared memory

  for (int u = u0; u < u1; ++u) {
    const int m0 = (u / per_strip) * Q_ROWS, n0 = (u % per_strip) * Q_BN + wg * W_BN;
    const bool live = n0 < p.N;  // the unit's last tile may lie past N
    int acc[W_BN / 2];
    for (int c0 = 0; c0 < nk; c0 += ck) {
      if (nk > ck || m0 != held) {
        consumers_sync();  // every consumer warpgroup done with the strip's last wgmma
        quantize_strip<XT>(p, strip, m0, c0 * W_BK, min(ck, nk - c0) * W_BK, tid);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumers_sync();
        held = m0;
      }
      for (int kt = c0; kt < min(c0 + ck, nk); ++kt) {
        mbar_wait(&full[stage], phase);
        if (live) {
          const uint8_t* const a = strip + (kt - c0) * Q_KT_BYTES;
          const uint8_t* const b = ring + stage * Q_STAGE_BYTES + wg * W_BN * W_BK;
          wgmma_fence();
          fence_acc(acc);
#pragma unroll
          for (int kk = 0; kk < W_BK / 32; ++kk)
            wgmma_n128(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk), (kt | kk) != 0);
          wgmma_commit();
          wgmma_wait_all();
          fence_acc(acc);
        }
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    if (!live) continue;

    named_sync(2 + wg);  // the warpgroup done with the last unit's constants
    for (int c = wtid; c < W_BN; c += 128) {
      const int col = n0 + c;
      const bool in = col < p.N;
      Cs[c] = in ? p.colsum[col] : 0;
      Sw[c] = in ? dequant_scale(p, col) : 0.0f;
      Bi[c] = in && has_bias ? p.bias[col] : 0.0f;
    }
    named_sync(2 + wg);
    // acc[4 j + 2 r + h]: row 16 wwarp + g + 8 r, column 8 j + 2 t4 + h,
    // stored from the registers: a warp's store covers 8 rows x 8 columns
    const bool even_n = p.N % 2 == 0;
#pragma unroll
    for (int j = 0; j < W_BN / 8; ++j) {
      const int lc = 8 * j + 2 * t4, col = n0 + lc;
      if (col >= p.N) continue;
      const int2 cs = *reinterpret_cast<const int2*>(Cs + lc);
      const float2 sw = *reinterpret_cast<const float2*>(Sw + lc);
      const float2 bi = *reinterpret_cast<const float2*>(Bi + lc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + 16 * wwarp + g + 8 * r;
        if (row >= p.M) continue;
        const float y0 = dequant_value(acc[4 * j + 2 * r], p.z_s, cs.x, sw.x, has_bias, bi.x);
        const float y1 = dequant_value(acc[4 * j + 2 * r + 1], p.z_s, cs.y, sw.y, has_bias, bi.y);
        OutT* const dst = y + (size_t)row * p.N + col;
        store_out(dst, y0, y1, even_n);
        if (!even_n && col + 1 < p.N) store_out(dst + 1, y1, 0.0f, false);
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

// the SM count of device dev, read once
int sm_count(int dev) {
  static int sms[MAX_DEVICES] = {};
  if (dev < MAX_DEVICES && sms[dev] > 0) return sms[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < MAX_DEVICES) sms[dev] = n;
  return n;
}

template <int EPI, typename OutT, int CONS, int STAGES, int ACT>
int launch_cfg(const GemmParams& p, cudaStream_t stream) {
  using C = Cfg<CONS, STAGES>;
  CUtensorMap ma, mw;
  if (!kmajor_map(&ma, p.a, p.M, p.K, C::ROWS) || !kmajor_map(&mw, p.w, p.N, p.K, W_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = int8_wgmma_kernel<EPI, OutT, CONS, STAGES, ACT>;
  const size_t smem = wgmma_smem_bytes<EPI, OutT, CONS, STAGES>();
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool opted_in[MAX_DEVICES] = {};  // the shared-memory opt-in, once per device
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  const int tiles = (p.M + C::ROWS - 1) / C::ROWS * ((p.N + W_BN - 1) / W_BN);
  const int sms = sm_count(dev);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int grid = std::min(tiles, sms);
  kernel<<<grid, C::THREADS, smem, stream>>>(ma, mw, p);
  return static_cast<int>(cudaGetLastError());
}

// the wide form where its shared memory fits, then the wide form with one
// stage fewer (at least two), else the narrow one
template <int EPI, typename OutT, int ACT = 0>
int launch_wgmma(const GemmParams& p, cudaStream_t stream) {
  if constexpr (wgmma_smem_bytes<EPI, OutT, W_CONSUMERS, W_STAGES>() <= W_SMEM_MAX)
    return launch_cfg<EPI, OutT, W_CONSUMERS, W_STAGES, ACT>(p, stream);
  else if constexpr (W_STAGES > 2 &&
                     wgmma_smem_bytes<EPI, OutT, W_CONSUMERS, W_STAGES - 1>() <= W_SMEM_MAX)
    return launch_cfg<EPI, OutT, W_CONSUMERS, W_STAGES - 1, ACT>(p, stream);
  else
    return launch_cfg<EPI, OutT, W_NARROW_CONSUMERS, W_NARROW_STAGES, ACT>(p, stream);
}

// K7: the strip holds min(K, Q_MAX_CHUNK) k bytes (rounded up to W_BK), the
// ring takes as many stages (at most Q_MAX_STAGES) as the rest fits
template <typename XT, typename OutT>
int launch_quantize_gemm(const GemmParams& p, cudaStream_t stream) {
  const int chunk_k = std::min((p.K + W_BK - 1) / W_BK * W_BK, Q_MAX_CHUNK);
  const int stages = static_cast<int>(std::min<size_t>(
      Q_MAX_STAGES, (W_SMEM_MAX - q_smem_bytes(chunk_k, 0)) / (Q_STAGE_BYTES + 16)));
  CUtensorMap mw;
  if (stages < 2 || !kmajor_map(&mw, p.w, p.N, p.K, W_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = quantize_gemm_kernel<XT, OutT>;
  const size_t smem = q_smem_bytes(chunk_k, stages);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool opted_in[MAX_DEVICES] = {};  // the shared-memory opt-in, once per device
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(W_SMEM_MAX));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  const int units = (p.M + Q_ROWS - 1) / Q_ROWS * ((p.N + Q_BN - 1) / Q_BN);
  const int sms = sm_count(dev);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  kernel<<<std::min(units, sms), Q_THREADS, smem, stream>>>(mw, p, chunk_k, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = dequant(a @ w_t^T) for a [M, K] shifted int8 and w_t [N, K] int8 (the
// weight packed k-contiguous), both 16-byte aligned with K a multiple of 16;
// epilogue PLAIN (y f32 or bf16), PLAIN_Q8 (y bf16, q [M, q_n] int8 of the
// first q_n columns) or GELU_Q (q [M, N] int8 of act(y)). Returns a
// cudaError_t (0 = launched); allocates nothing and does not synchronise.
extern "C" int qvt_int8_gemm(const void* a, const void* w_t, const void* colsum,
                             const void* bias, const void* wscale, void* y, void* q, int M,
                             int N, int K, int epilogue, int out_bf16, int ws_per_channel,
                             int act, float ws0, float s_x, int z_s, float inv_s, float zp,
                             float qmax, int q_n, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(w_t) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmParams p{};
  p.a = a;
  p.w = static_cast<const int8_t*>(w_t);
  p.colsum = static_cast<const int32_t*>(colsum);
  p.bias = static_cast<const float*>(bias);
  p.wscale = static_cast<const float*>(wscale);
  p.y = y;
  p.q = static_cast<int8_t*>(q);
  p.M = M;
  p.N = N;
  p.K = K;
  p.ws_per_channel = ws_per_channel;
  p.act = act;
  p.ws0 = ws0;
  p.s_x = s_x;
  p.z_s = z_s;
  p.inv_s = inv_s;
  p.zp = zp;
  p.qmax = qmax;
  p.q_n = q_n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  if (epilogue == EPI_GELU_Q)
    return act == 1 ? launch_wgmma<EPI_GELU_Q, int8_t, 1>(p, s)
                    : launch_wgmma<EPI_GELU_Q, int8_t, 0>(p, s);
  if (epilogue == EPI_PLAIN_Q8) {  // bf16 y, as K6's qkv stage stores it
    if (!out_bf16 || q_n <= 0 || q_n > N) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma<EPI_PLAIN_Q8, bf16>(p, s);
  }
  if (epilogue != EPI_PLAIN) return static_cast<int>(cudaErrorInvalidValue);
  if (out_bf16) return launch_wgmma<EPI_PLAIN, bf16>(p, s);
  return launch_wgmma<EPI_PLAIN, float>(p, s);
}

// K7: x [M, K] f32 (x_bf16 = 0) or bf16, 16-byte aligned, is quantized with
// (x_inv_s, x_zp, x_qmax) into shifted int8, multiplied by w_t [N, K] int8
// (the weight packed k-contiguous) and dequantized by the PLAIN epilogue
// with the input scale s_x and z_s = x_zp - 128 into y [M, N] (f32 or
// bf16); K a multiple of 16. Returns a cudaError_t (0 = launched).
extern "C" int qvt_quantize_gemm(const void* x, const void* w_t, const void* colsum,
                                 const void* bias, const void* wscale, void* y, int M, int N,
                                 int K, int x_bf16, int out_bf16, int ws_per_channel, float ws0,
                                 float s_x, int z_s, float x_inv_s, float x_zp, float x_qmax,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w_t) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmParams p{};
  p.a = x;
  p.w = static_cast<const int8_t*>(w_t);
  p.colsum = static_cast<const int32_t*>(colsum);
  p.bias = static_cast<const float*>(bias);
  p.wscale = static_cast<const float*>(wscale);
  p.y = y;
  p.M = M;
  p.N = N;
  p.K = K;
  p.ws_per_channel = ws_per_channel;
  p.ws0 = ws0;
  p.s_x = s_x;
  p.z_s = z_s;
  p.a_inv_s = x_inv_s;
  p.a_zp = x_zp;
  p.a_qmax = x_qmax;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  if (x_bf16)
    return out_bf16 ? launch_quantize_gemm<bf16, bf16>(p, s) : launch_quantize_gemm<bf16, float>(p, s);
  return out_bf16 ? launch_quantize_gemm<float, bf16>(p, s) : launch_quantize_gemm<float, float>(p, s);
}
