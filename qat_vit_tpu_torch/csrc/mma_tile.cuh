// Tensor-core building blocks of the streaming attention kernels
// (attention_long_mma.cu, attention_long_bwd_mma.cu), for sm_90a: bf16
// tiles in shared memory, read into mma.sync fragments with ldmatrix.
//
// Fragments of mma.sync.m16n8k16 (bf16 in, f32 accumulate), for lane l of a
// warp with g = l / 4 and t = l % 4:
//   A (16 x 16, row-major), 4 words: a0 = A[g][2t, 2t+1], a1 = A[g+8][2t..],
//     a2 = A[g][2t+8..], a3 = A[g+8][2t+8..];
//   B (16 x 8, "col": stored as [n][k]), 2 words: b0 = B[2t, 2t+1][g],
//     b1 = B[2t+8, 2t+9][g];
//   C (16 x 8 f32), 4 floats: c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t..].
// So the C fragments of two adjacent 8-column tiles are, packed to bf16, the
// A fragment of their 16 columns (P of S = Q K^T feeds P V as it lies).
//
// Tiles live in shared memory as rows of HDP + 8 bf16 (HDP the head dim the
// kernel is built for, 64 or 128): a row is an odd number of 16-byte chunks,
// so the 8 rows one ldmatrix matrix reads fall on 8 different bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qvt_mma {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(const bf16* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(const bf16* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b (m16n8k16, bf16 operands, f32 accumulators)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

// 2^x (MUFU.EX2; 0 for x far below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte cp.async that writes zeros instead when !valid (src is not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte cp.async (.ca: the only form below 16 bytes), zeros when !valid
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// rows [r0, r0 + ROWS) of one head's hd columns of a packed [*, ld] bf16
// tensor (src points at row 0, column 0 of the head) into a [ROWS][HDP + 8]
// tile: chunks of 8 columns up to hdp (hd rounded up to 16); rows >= rows_ok
// and the chunk past hd (hd % 16 == 8) are zero-filled. One commit group.
template <int ROWS, int HDP, int THREADS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, size_t ld, int r0,
                                          int rows_ok, int hd) {
  constexpr int SROW = HDP + 8, CH = HDP / 8;  // a row's chunks at the widest hd
  const int nch = ((hd + 15) & ~15) / 8, hch = hd / 8;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    if (c >= nch) continue;
    const bool ok = r0 + r < rows_ok && c < hch;
    cp_async16_zfill(tile + r * SROW + 8 * c, ok ? src + (size_t)(r0 + r) * ld + 8 * c : src, ok);
  }
}

// the same rows with q scaled by `scale` in bf16 (bf16(f32(q) * scale), the
// product rounded once), through registers
template <int ROWS, int HDP, int THREADS>
__device__ __forceinline__ void load_tile_scaled(bf16* tile, const bf16* src, size_t ld, int r0,
                                                 int rows_ok, int hd, float scale) {
  constexpr int SROW = HDP + 8, CH = HDP / 8;
  const int nch = ((hd + 15) & ~15) / 8, hch = hd / 8;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    if (c >= nch) continue;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows_ok && c < hch) {
      w = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + 8 * c);
      uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(u[e]);
        u[e] = pack_bf16(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
      }
    }
    *reinterpret_cast<uint4*>(tile + r * SROW + 8 * c) = w;
  }
}

// A fragment of 16 rows (`rows` points at the first) and columns
// [16 ks, 16 ks + 16)
template <int HDP>
__device__ __forceinline__ void frag_a(const bf16* rows, int ks, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(rows + (lane & 15) * (HDP + 8) + 16 * ks + (lane >> 4) * 8, a);
}

// B fragments of two 8-row tiles (rows r0 .. r0 + 15 of `tile` as n, its
// columns [16 ks, 16 ks + 16) as k): b[0], b[1] for rows r0.., b[2], b[3]
// for rows r0 + 8..
template <int HDP>
__device__ __forceinline__ void frag_b(const bf16* tile, int r0, int ks, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(tile + (r0 + (lane & 7) + ((lane >> 4) << 3)) * (HDP + 8) + 16 * ks +
              ((lane >> 3) & 1) * 8,
          b);
}

// B fragments with the tile's rows as k and its columns as n: rows
// [k0, k0 + 16) and columns [16 dp, 16 dp + 16): b[0], b[1] for columns
// 16 dp.., b[2], b[3] for columns 16 dp + 8..
template <int HDP>
__device__ __forceinline__ void frag_bt(const bf16* tile, int k0, int dp, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * (HDP + 8) + 16 * dp +
                (lane >> 4) * 8,
            b);
}

}  // namespace qvt_mma
