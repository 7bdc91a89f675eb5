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
//   the outputs are bit-identical to gemm_tile.cuh's CUDA-core tile and to
//   the plain versions, ops/fused_serve.int8_dense*_plain); each warpgroup
//   writes its outputs into a padded shared-memory tile and then copies
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

#include <cuda.h>  // CUtensorMap and the cuTensorMapEncodeTiled enums

#include <algorithm>

#include "gemm_tile.cuh"

namespace {

using namespace qvt;
using namespace qvt::gemm;

constexpr int W_BN = 128;         // output columns per tile: one m64n128k32 wgmma
constexpr int W_BK = 128;         // k bytes per stage: one 128-byte swizzle row
// consumer warpgroups (64 rows each) and ring stages: the wide form where its
// shared memory fits (PLAIN bf16, GELU_Q), the wide form with one stage fewer
// (PLAIN_Q8), else the narrow one (PLAIN f32, whose output staging is largest)
constexpr int W_CONSUMERS = 4;
constexpr int W_STAGES = 3;
constexpr int W_NARROW_CONSUMERS = 2;
constexpr int W_NARROW_STAGES = 4;
constexpr size_t W_SMEM_MAX = 232448;

// the shape of a launch with CONS consumer warpgroups and STAGES ring stages
template <int CONS, int STAGES>
struct Cfg {
  static constexpr int ROWS = 64 * CONS;  // A rows of a stage = tile rows
  static constexpr int THREADS = 128 * CONS + 32;
  static constexpr int STAGE_BYTES = (ROWS + W_BN) * W_BK;
  static_assert(ROWS <= 256, "TMA box <= 256 rows");
};

// the output staging tile of one warpgroup: 64 rows of W_BN elements of T,
// padded by 16 bytes (conflict-free pair stores, 16-byte aligned rows)
template <typename T>
__host__ __device__ constexpr int stage_pitch() { return W_BN * static_cast<int>(sizeof(T)) + 16; }

template <int EPI, typename OutT>
__host__ __device__ constexpr int staging_bytes() {
  return 64 * ((EPI == EPI_GELU_Q ? 0 : stage_pitch<OutT>()) +
               (EPI == EPI_PLAIN ? 0 : stage_pitch<int8_t>()));
}

template <int EPI, typename OutT, int CONS, int STAGES>
constexpr size_t wgmma_smem_bytes() {
  using C = Cfg<CONS, STAGES>;
  return 1024 /* alignment slack */ + (size_t)STAGES * C::STAGE_BYTES +
         (size_t)CONS * (staging_bytes<EPI, OutT>() + 3 * 4 * W_BN) + 2 * 8 * STAGES;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a [box] tile at (c0 = k byte, c1 = row) of the tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// the wgmma descriptor of a K-major tile of 128-byte rows written by TMA with
// the 128-byte swizzle (8-row groups 1024 bytes apart; the tile 1024-byte
// aligned, so a k offset inside the row is added to the start address)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving the accumulators across the asynchronous
// wgmma sequence (CUTLASS's warpgroup_fence_operand)
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 32] B[128 x 32]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// rows [0, 64) x W_BN columns of staged T (pitch bytes a row) to out[m0 +
// r, n0 + c] (ld elements a row, columns < ncols, rows < M): whole 16-byte
// segments where the row pitch keeps them aligned, elements at the edge
template <typename T>
__device__ __forceinline__ void copy_out(const uint8_t* st, T* out, int ld, int ncols, int m0,
                                         int n0, int M, int wtid) {
  constexpr int E = 16 / sizeof(T), CH = W_BN / E, PITCH = stage_pitch<T>();
  const bool vec = ld % E == 0;
  for (int c = wtid; c < 64 * CH; c += 128) {
    const int r = c / CH, col = n0 + (c % CH) * E, row = m0 + r;
    if (row >= M || col >= ncols) continue;
    const uint8_t* src = st + r * PITCH + (c % CH) * 16;
    T* dst = out + (size_t)row * ld + col;
    if (vec && col + E <= ncols) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else {
      for (int e = 0; e < E && col + e < ncols; ++e) dst[e] = reinterpret_cast<const T*>(src)[e];
    }
  }
}

__device__ __forceinline__ void store_pair(uint8_t* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(uint8_t* p, __nv_bfloat16 a, __nv_bfloat16 b) {
  __nv_bfloat162 v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}
__device__ __forceinline__ void store_pair(uint8_t* p, int8_t a, int8_t b) {
  *reinterpret_cast<uint16_t*>(p) =
      static_cast<uint16_t>(static_cast<uint8_t>(a) | (static_cast<uint8_t>(b) << 8));
}

// ACT: GELU_Q's activation (0 tanh-GELU, 1 quick-GELU), a template argument so
// that no element's epilogue branches on it
template <int EPI, typename OutT, int CONS, int STAGES, int ACT>
__global__ void __launch_bounds__(Cfg<CONS, STAGES>::THREADS, 1)
    int8_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_w, const GemmParams p) {
  using C = Cfg<CONS, STAGES>;
  constexpr int ROWS = C::ROWS, STAGE_BYTES = C::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const ring = smem;
  uint8_t* const staging = ring + STAGES * STAGE_BYTES;
  constexpr int STG = staging_bytes<EPI, OutT>();
  uint8_t* const consts = staging + CONS * STG;
  uint64_t* const full = reinterpret_cast<uint64_t*>(consts + CONS * 3 * 4 * W_BN);
  uint64_t* const empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (p.N + W_BN - 1) / W_BN;
  const int tiles = (p.M + ROWS - 1) / ROWS * n_tiles;
  const int nk = (p.K + W_BK - 1) / W_BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONS);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONS) {  // the producer warp: one thread starts the copies
    if (lane != 0) return;
    int stage = 0, phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles) * ROWS, n0 = (t % n_tiles) * W_BN;
      for (int kt = 0; kt < nk; ++kt) {
        uint64_t* const f = &full[stage];
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(f, STAGE_BYTES);
        uint8_t* const st = ring + stage * STAGE_BYTES;
        tma_load(st, &tma_a, f, kt * W_BK, m0);
        tma_load(st + ROWS * W_BK, &tma_w, f, kt * W_BK, n0);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup
  const int wg = warp >> 2, wtid = tid & 127, wwarp = warp & 3;
  uint8_t* const my_stage = staging + wg * STG;
  int* const Cs = reinterpret_cast<int*>(consts + wg * 3 * 4 * W_BN);
  float* const Sw = reinterpret_cast<float*>(Cs + W_BN);
  float* const Bi = Sw + W_BN;
  const bool has_bias = p.bias != nullptr;
  const int g = lane >> 2, t4 = lane & 3;
  int stage = 0, phase = 0;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    // this warpgroup's 64 rows of the tile
    const int m0 = (t / n_tiles) * ROWS + 64 * wg, n0 = (t % n_tiles) * W_BN;
    // the tile's per-column constants (dequant_scale: s_x * w_scale[n])
    for (int c = wtid; c < W_BN; c += 128) {
      const int col = n0 + c;
      const bool in = col < p.N;
      Cs[c] = in ? p.colsum[col] : 0;
      Sw[c] = in ? dequant_scale(p, col) : 0.0f;
      Bi[c] = in && has_bias ? p.bias[col] : 0.0f;
    }

    int acc[W_BN / 2];
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[stage], phase);
      const uint8_t* const a = ring + stage * STAGE_BYTES + 64 * wg * W_BK;
      const uint8_t* const b = ring + stage * STAGE_BYTES + ROWS * W_BK;
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < W_BK / 32; ++kk)
        wgmma_n128(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk), (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    named_sync(1 + wg);  // the constants visible; the last tile's copy-out done

    // acc[4 j + 2 r + h]: row 16 wwarp + g + 8 r, column 8 j + 2 t4 + h; each
    // column pair's constants are read once for both rows
#pragma unroll
    for (int j = 0; j < W_BN / 8; ++j) {
      const int lc = 8 * j + 2 * t4;
      const int2 cs = *reinterpret_cast<const int2*>(Cs + lc);
      const float2 sw = *reinterpret_cast<const float2*>(Sw + lc);
      const float2 bi = *reinterpret_cast<const float2*>(Bi + lc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = 16 * wwarp + g + 8 * r;
        const float y0 = dequant_value(acc[4 * j + 2 * r], p.z_s, cs.x, sw.x, has_bias, bi.x);
        const float y1 =
            dequant_value(acc[4 * j + 2 * r + 1], p.z_s, cs.y, sw.y, has_bias, bi.y);
        if constexpr (EPI == EPI_GELU_Q) {
          store_pair(my_stage + lr * stage_pitch<int8_t>() + lc,
                     quantize_shifted(activation(y0, ACT), p.inv_s, p.zp, p.qmax),
                     quantize_shifted(activation(y1, ACT), p.inv_s, p.zp, p.qmax));
        } else {
          store_pair(my_stage + lr * stage_pitch<OutT>() + lc * sizeof(OutT), from_f32<OutT>(y0),
                     from_f32<OutT>(y1));
          if constexpr (EPI == EPI_PLAIN_Q8)
            store_pair(my_stage + 64 * stage_pitch<OutT>() + lr * stage_pitch<int8_t>() + lc,
                       quantize_shifted(y0, p.inv_s, p.zp, p.qmax),
                       quantize_shifted(y1, p.inv_s, p.zp, p.qmax));
        }
      }
    }
    named_sync(1 + wg);

    if constexpr (EPI == EPI_GELU_Q) {
      copy_out<int8_t>(my_stage, p.q, p.N, p.N, m0, n0, p.M, wtid);
    } else {
      copy_out<OutT>(my_stage, static_cast<OutT*>(p.y), p.N, p.N, m0, n0, p.M, wtid);
      if constexpr (EPI == EPI_PLAIN_Q8)
        if (n0 < p.q_n)
          copy_out<int8_t>(my_stage + 64 * stage_pitch<OutT>(), p.q, p.q_n, p.q_n, m0, n0, p.M,
                           wtid);
    }
  }
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

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a K-contiguous int8 [rows, K] matrix as [box_rows x 128 B] tiles, 128-byte
// swizzle, zeros outside it
bool kmajor_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(W_BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
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
