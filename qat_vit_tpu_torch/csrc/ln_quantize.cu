// LayerNorm -> shifted int8 (K2d), for sm_90a.
//
// Replaces (TPU, Pallas): qat_vit_tpu/ops/fused_serve.py::_ln_q_kernel (K2d).
// The port uses it for the entry LN of block 0 (the JAX megamodel path does
// that one in XLA) and wherever an LN output feeds an int8 GEMM with no GEMM
// before it.
//
// q = clamp(rint(LN(x) * inv_s + zp), 0, qmax) - 128, LN with f32
// statistics: mean, then mean((x - mean)^2), 1 / sqrt(var + eps), gamma,
// beta. Both forms (and K2c) take the statistics from qvt::row_stats_f64:
// f64 sums, then the values of / N and 1 / sqrt in f64 rounded to f32 once,
// as the plain version (ops/fused_serve.ln_quantize_plain) computes them, in
// another summation order; common.cuh says what that order can move.
// Bit-identical to the plain version on every input tested.
//
// What bounds it on an H100: device memory first. It reads 2 (bf16) or 4
// (f32) bytes and writes 1 byte per element, with ~10 f32 operations per
// element, far below the card's ~300 operations/byte; at ViT-S batch 256
// ([50432, 384] bf16) the least time is ~58 MB / 3.35 TB/s = ~17 us. Second,
// the f64 statistics: a conversion and one or two f64 operations per element
// on the SM's 64-lane f64 pipe and conversion rate, and per row two f64 warp
// sums, two divisions, a square root and a reciprocal, which every lane
// runs; row_stats_f64 gets their values without the divisions and, but for
// about one row in 2^25, the square root (measured: 8% of the time at
// [50432, 384] bf16 with them, port_scripts/k2d_variants.py). The first
// design (one warp per row, three passes) read each row three times, the
// second and third from L1/L2, converted each element to f64 twice, rounded
// with rint and converted to int: 0.040 ms at [50432, 384] bf16, where the
// bytes alone would take 0.017.
//
// The register form (rows of 4-byte multiples up to REG_SLOTS x 32 = 1,024
// elements), what it does about each:
// - Each element is read from device memory once: one warp holds its row in
//   registers, lane l loads vectors l, l + 32, ... of 8 or 16 bytes (NV of
//   them, a template argument), so each of a warp's loads is 256 or 512
//   contiguous bytes. qvt_ln_quantize picks the form and NV by ln_plan below
//   (ops/fused_serve.ln_quantize_plan is its mirror).
// - The f64 work: each element is unpacked once; for bf16 rows of up to
//   CACHE_SLOTS slots a lane its f64 value is kept from the first sum for
//   the second (one conversion, not two; f32 rows measured faster without).
// - The quantize has no conversion instruction: the grid value is the low
//   byte of clamp(t) + 1.5 * 2^23, four of them packed with byte_perm and
//   written as 4 or 8 bytes a lane.
// - Latency: the grid holds as many blocks as are resident on the card at
//   once and each warp walks rows w, w + W, ...; the loads of its next row
//   are issued before it reduces the current one. gamma and beta are loaded
//   once per warp and kept in registers. More rows in flight measured
//   slower: their registers cost warps.
// port_scripts/k2d_variants.py times text-patched builds of this file
// against it (other constants, more rows in flight, ablations).
// The strided form (any other row: N not a multiple of 4, a row the vectors
// cannot take at its alignment, or N past the register plan): the first
// design, one warp per row and three passes.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int MAX_DEVICES = 64;
// the register form: warps per block, the most row elements a lane holds,
// and the most slots of a bf16 row a lane keeps f64 copies of
constexpr int REG_WARPS = 4;
constexpr int REG_SLOTS = 32;
constexpr int CACHE_SLOTS = 24;
// the strided form: rows (one warp each) per block
constexpr int ROWS_PER_BLOCK = 8;

// (vector bytes, vectors per lane) of the register form for a row of n
// elements of elem bytes at data address addr; vec 0: the strided form. Of
// the vector widths a row takes (16 bytes, and for bf16 also 8), the one
// whose lanes hold the fewest element slots, the wider on a tie; int8 stores
// of at least 4 bytes a lane need n % 4 == 0.
struct Plan {
  int vec, nv;
};

Plan ln_plan(int n, int elem, uintptr_t addr) {
  Plan best{0, 0};
  if (n <= 0 || n % 4) return best;
  int best_slots = REG_SLOTS + 1;
  for (int vec : {16, 8}) {
    if (vec == 8 && elem != 2) continue;
    const int e = vec / elem;
    if (n % e || addr % vec) continue;
    const int nv = (n / e + 31) / 32;
    if (nv * e < best_slots) {
      best = {vec, nv};
      best_slots = nv * e;
    }
  }
  return best_slots <= REG_SLOTS ? best : Plan{0, 0};
}

template <int VEC>
__device__ __forceinline__ void load_vec(const void* p, uint32_t (&w)[VEC / 4]) {
  if constexpr (VEC == 16) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  }
}

// the E = VEC / sizeof(T) elements of a vector as f32
template <typename T, int VEC>
__device__ __forceinline__ void unpack_vec(const uint32_t (&w)[VEC / 4],
                                           float (&f)[VEC / sizeof(T)]) {
  constexpr int PER_WORD = 4 / sizeof(T);
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i) {
    float part[PER_WORD];
    qvt::unpack_word<T>(w[i], part);
#pragma unroll
    for (int j = 0; j < PER_WORD; ++j) f[i * PER_WORD + j] = part[j];
  }
}

// rint(clamp(v * inv_s + zp, 0, qmax)) + 12582912 (1.5 * 2^23) as f32 bits,
// whose low byte is the grid value: clamping before the rounding gives the
// integer qvt::quantize_shifted gives (qmax is one), and for 0 <= t <= qmax
// < 2^22 the sum holds rint(t) (half to even) in its low mantissa bits. No
// conversion instruction (16 per clock on an SM against 128 f32 operations).
__device__ __forceinline__ uint32_t quantize_bits(float v, float inv_s, float zp, float qmax) {
  const float t = fminf(fmaxf(__fadd_rn(__fmul_rn(v, inv_s), zp), 0.0f), qmax);
  return __float_as_uint(__fadd_rn(t, 12582912.0f));
}

// one row of the register form: the row's vectors in raw (this lane's NV),
// gamma and beta of this lane's columns in g and b, inv_n = RN(1 / n)
template <typename T, int VEC, int NV>
__device__ __forceinline__ void ln_row(const uint32_t (&raw)[NV][VEC / 4],
                                       const float (&g)[NV][VEC / sizeof(T)],
                                       const float (&b)[NV][VEC / sizeof(T)], int8_t* qr,
                                       int lane, int n, double inv_n, int nvec, float inv_s,
                                       float zp, float qmax, float eps) {
  constexpr int E = VEC / sizeof(T);
  // the row's f64 values kept from the first sum for the second, where the
  // registers allow: one conversion per element instead of two
  constexpr bool CACHE = sizeof(T) == 2 && NV * E <= CACHE_SLOTS;
  float f[NV][E];
#pragma unroll
  for (int v = 0; v < NV; ++v) unpack_vec<T, VEC>(raw[v], f[v]);
  double xd[CACHE ? NV : 1][CACHE ? E : 1];
  double s = 0.0;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (v * 32 + lane < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const double d = static_cast<double>(f[v][e]);
        if constexpr (CACHE) xd[v][e] = d;
        s += d;
      }
    }
  }
  const float2 st = qvt::row_stats_f64(s, n, inv_n, eps, [&](double mean) {
    double var = 0.0;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (v * 32 + lane < nvec) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          double d;
          if constexpr (CACHE)
            d = xd[v][e] - mean;
          else
            d = static_cast<double>(f[v][e]) - mean;
          var += d * d;
        }
      }
    }
    return var;
  });
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (v * 32 + lane < nvec) {
      uint32_t bits[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        bits[e] = quantize_bits(qvt::ln_affine(f[v][e], st, g[v][e], b[v][e]), inv_s, zp, qmax);
      // the low bytes of four values, then (grid value - 128) = grid value ^ 0x80
      uint32_t packed[E / 4];
#pragma unroll
      for (int k = 0; k < E / 4; ++k)
        packed[k] = __byte_perm(__byte_perm(bits[4 * k], bits[4 * k + 1], 0x0040),
                                __byte_perm(bits[4 * k + 2], bits[4 * k + 3], 0x0040), 0x5410) ^
                    0x80808080u;
      int8_t* dst = qr + (v * 32 + lane) * E;
      if constexpr (E == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
      else
        *reinterpret_cast<uint32_t*>(dst) = packed[0];
    }
  }
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(REG_WARPS * 32)
    ln_quantize_regs(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, int8_t* __restrict__ q, int M, int N,
                     float inv_s, float zp, float qmax, float eps) {
  constexpr int E = VEC / sizeof(T);  // elements of a vector
  constexpr int W = VEC / 4;          // its 32-bit words
  const int lane = threadIdx.x & 31;
  const int nvec = N / E;
  const double inv_n = 1.0 / N;
  const int stride = gridDim.x * REG_WARPS;
  const int row = blockIdx.x * REG_WARPS + (threadIdx.x >> 5);
  if (row >= M) return;  // the whole warp

  float g[NV][E], b[NV][E];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = (v * 32 + lane) * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool ok = v * 32 + lane < nvec;
      g[v][e] = ok ? gamma[c + e] : 0.0f;
      b[v][e] = ok ? beta[c + e] : 0.0f;
    }
  }

  const auto load_row = [&](int r, uint32_t(&dst)[NV][W]) {
    const char* base = reinterpret_cast<const char*>(x + static_cast<size_t>(r) * N);
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (v * 32 + lane < nvec) load_vec<VEC>(base + static_cast<size_t>(v * 32 + lane) * VEC,
                                              dst[v]);
  };
  // the warp's rows row, row + stride, ...: the next row's loads go out as
  // soon as the current row is copied out, before it is reduced
  uint32_t next[NV][W];
  load_row(row, next);
  for (int r = row; r < M; r += stride) {
    uint32_t cur[NV][W];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < W; ++i) cur[v][i] = next[v][i];
    if (r + stride < M) load_row(r + stride, next);
    ln_row<T, VEC, NV>(cur, g, b, q + static_cast<size_t>(r) * N, lane, N, inv_n, nvec, inv_s,
                       zp, qmax, eps);
  }
}

template <typename T>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
    ln_quantize_strided(const T* x, const float* gamma, const float* beta, int8_t* q, int M,
                        int N, float inv_s, float zp, float qmax, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= M) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + (size_t)row * N;
  const auto load = [&](int c) { return qvt::to_f32(xr[c]); };
  const float2 st = qvt::warp_row_stats(load, N, eps);
  for (int c = lane; c < N; c += 32) {
    const float z = qvt::ln_affine(load(c), st, gamma[c], beta[c]);
    q[(size_t)row * N + c] = qvt::quantize_shifted(z, inv_s, zp, qmax);
  }
}

struct Args {
  const void* x;
  const float* gamma;
  const float* beta;
  int8_t* q;
  int M, N;
  float inv_s, zp, qmax, eps;
};

// the blocks of the register form resident on device dev at once, read once
template <typename T, int VEC, int NV>
int resident_blocks(int dev) {
  static int blocks[MAX_DEVICES] = {};
  if (dev < MAX_DEVICES && blocks[dev] > 0) return blocks[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_quantize_regs<T, VEC, NV>,
                                                    REG_WARPS * 32, 0) != cudaSuccess)
    return 0;
  const int n = sms * per_sm;
  if (dev < MAX_DEVICES) blocks[dev] = n;
  return n;
}

template <typename T, int VEC, int NV = 1>
int launch_regs(int nv, const Args& a, cudaStream_t s) {
  if constexpr (NV * (VEC / static_cast<int>(sizeof(T))) > REG_SLOTS) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (nv != NV) return launch_regs<T, VEC, NV + 1>(nv, a, s);
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int resident = resident_blocks<T, VEC, NV>(dev);
    if (resident <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    const int grid = std::min((a.M + REG_WARPS - 1) / REG_WARPS, resident);
    ln_quantize_regs<T, VEC, NV><<<grid, REG_WARPS * 32, 0, s>>>(
        static_cast<const T*>(a.x), a.gamma, a.beta, a.q, a.M, a.N, a.inv_s, a.zp, a.qmax,
        a.eps);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch(const Args& a, cudaStream_t s) {
  const Plan plan = ln_plan(a.N, sizeof(T), reinterpret_cast<uintptr_t>(a.x));
  if (plan.vec == 0) {
    ln_quantize_strided<T><<<(a.M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, ROWS_PER_BLOCK * 32,
                             0, s>>>(static_cast<const T*>(a.x), a.gamma, a.beta, a.q, a.M,
                                     a.N, a.inv_s, a.zp, a.qmax, a.eps);
    return static_cast<int>(cudaGetLastError());
  }
  if (plan.vec == 16) return launch_regs<T, 16>(plan.nv, a, s);
  if constexpr (sizeof(T) == 2) return launch_regs<T, 8>(plan.nv, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// the form (register or strided) and its vectors come from ln_plan
extern "C" int qvt_ln_quantize(const void* x, const void* gamma, const void* beta, void* q,
                               int M, int N, int x_bf16, float inv_s, float zp, float qmax,
                               float eps, void* stream) {
  if (M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const float*>(gamma), static_cast<const float*>(beta),
               static_cast<int8_t*>(q), M, N, inv_s, zp, qmax, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}

extern "C" const char* qvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
