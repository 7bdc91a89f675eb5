// The TMA + wgmma int8 GEMM of csrc/int8_gemm_wgmma.cu (K2a, K2b and the
// PLAIN_Q8 form; its design is that file's header) as __device__ building
// blocks: the ring's producer loop and the consumer warpgroups' loop with its
// epilogue. int8_gemm_wgmma.cu's kernel runs them once per launch; K9's
// cooperative kernel (csrc/megablock.cu) runs its qkv and fc1 stages on them,
// one ring carried across both, so the outputs are the chain's bit for bit.
// Also the TMA, mbarrier and wgmma wrappers K7's kernel uses, and the
// host-side tensor-map encoder.
#pragma once

#include <cuda.h>  // CUtensorMap and the cuTensorMapEncodeTiled enums

#include "gemm_tile.cuh"

namespace qvt_wgmma {

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

// The ring's position (stage, parity), advanced alike by the producer and by
// every consumer warp over the same sequence of (tile, k-step): a launch that
// runs several GEMMs on one ring (K9) carries it from one to the next, so the
// mbarriers are initialised once.
struct Ring {
  int stage = 0, phase = 0;
  template <int STAGES>
  __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// k-step kt of the tile at (m0, n0): its A and W copies into the ring stage
// at r, once every consumer warp is done with that stage
template <int CONS, int STAGES>
__device__ __forceinline__ void fill_stage(const CUtensorMap* tma_a, const CUtensorMap* tma_w,
                                           uint8_t* ring, uint64_t* full, uint64_t* empty, int m0,
                                           int n0, int kt, Ring& r) {
  using C = Cfg<CONS, STAGES>;
  uint64_t* const f = &full[r.stage];
  mbar_wait(&empty[r.stage], r.phase ^ 1);
  mbar_expect_tx(f, C::STAGE_BYTES);
  uint8_t* const st = ring + r.stage * C::STAGE_BYTES;
  tma_load(st, tma_a, f, kt * W_BK, m0);
  tma_load(st + C::ROWS * W_BK, tma_w, f, kt * W_BK, n0);
  r.template next<STAGES>();
}

// The producer (one thread): TMA copies of the A and W k-steps of tiles t0,
// t0 + step, .. (row-major over [M / ROWS] x [N / W_BN] tiles) into the
// ring.
template <int CONS, int STAGES>
__device__ __forceinline__ void wgmma_produce(const CUtensorMap* tma_a, const CUtensorMap* tma_w,
                                              uint8_t* ring, uint64_t* full, uint64_t* empty,
                                              int M, int N, int K, int t0, int step, Ring& r) {
  constexpr int ROWS = Cfg<CONS, STAGES>::ROWS;
  const int n_tiles = (N + W_BN - 1) / W_BN;
  const int tiles = (M + ROWS - 1) / ROWS * n_tiles;
  const int nk = (K + W_BK - 1) / W_BK;
  for (int t = t0; t < tiles; t += step)
    for (int kt = 0; kt < nk; ++kt)
      fill_stage<CONS, STAGES>(tma_a, tma_w, ring, full, empty, (t / n_tiles) * ROWS,
                               (t % n_tiles) * W_BN, kt, r);
}

// A consumer warpgroup (threads 0 .. 128 CONS - 1, warpgroup threadIdx.x /
// 128) over the tiles of wgmma_produce: wgmma on its 64 rows of each stage,
// then the epilogue into its staging tile and out. staging: CONS x
// staging_bytes<EPI, OutT>(); consts: CONS x 3 x 4 x W_BN bytes.
// SELF: no producer warp; thread 0 also starts the copies (wgmma_produce's,
// from the tensor maps, with its own ring position *pr), STAGES - 1 k-steps
// ahead of the one it consumes, so a tile's first k-steps land during the
// previous tile's epilogue (K9's blocks, whose register budget a producer
// warp would cut).
template <int EPI, typename OutT, int CONS, int STAGES, int ACT, bool SELF = false>
__device__ __forceinline__ void wgmma_consume(const GemmParams& p, uint8_t* ring, uint8_t* staging,
                                              uint8_t* consts, uint64_t* full, uint64_t* empty,
                                              int t0, int step, Ring& r,
                                              const CUtensorMap* tma_a = nullptr,
                                              const CUtensorMap* tma_w = nullptr,
                                              Ring* pr = nullptr) {
  using C = Cfg<CONS, STAGES>;
  constexpr int ROWS = C::ROWS, STAGE_BYTES = C::STAGE_BYTES;
  constexpr int STG = staging_bytes<EPI, OutT>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (p.N + W_BN - 1) / W_BN;
  const int tiles = (p.M + ROWS - 1) / ROWS * n_tiles;
  const int nk = (p.K + W_BK - 1) / W_BK;
  const int wg = warp >> 2, wtid = tid & 127, wwarp = warp & 3;
  uint8_t* const my_stage = staging + wg * STG;
  int* const Cs = reinterpret_cast<int*>(consts + wg * 3 * 4 * W_BN);
  float* const Sw = reinterpret_cast<float*>(Cs + W_BN);
  float* const Bi = Sw + W_BN;
  const bool has_bias = p.bias != nullptr;
  const int g = lane >> 2, t4 = lane & 3;
  // SELF: the k-steps of this block's tiles in order, as items; items < issued
  // have their copies started
  const int items = t0 < tiles ? (tiles - t0 + step - 1) / step * nk : 0;
  int issued = 0, item = 0;

  for (int t = t0; t < tiles; t += step) {
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
      if constexpr (SELF) {
        if (tid == 0) {
          for (; issued < min(items, item + STAGES); ++issued) {
            const int it = t0 + step * (issued / nk);
            fill_stage<CONS, STAGES>(tma_a, tma_w, ring, full, empty, (it / n_tiles) * ROWS,
                                     (it % n_tiles) * W_BN, issued % nk, *pr);
          }
        }
        __syncwarp();
        ++item;
      }
      mbar_wait(&full[r.stage], r.phase);
      const uint8_t* const a = ring + r.stage * STAGE_BYTES + 64 * wg * W_BK;
      const uint8_t* const b = ring + r.stage * STAGE_BYTES + ROWS * W_BK;
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < W_BK / 32; ++kk)
        wgmma_n128(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk), (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[r.stage]);
      r.template next<STAGES>();
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
      for (int rr = 0; rr < 2; ++rr) {
        const int lr = 16 * wwarp + g + 8 * rr;
        const float y0 = dequant_value(acc[4 * j + 2 * rr], p.z_s, cs.x, sw.x, has_bias, bi.x);
        const float y1 =
            dequant_value(acc[4 * j + 2 * rr + 1], p.z_s, cs.y, sw.y, has_bias, bi.y);
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

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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
inline bool kmajor_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
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

}  // namespace qvt_wgmma
