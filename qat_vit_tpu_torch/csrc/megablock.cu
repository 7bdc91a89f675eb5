// Whole ViT blocks in ONE cooperative launch, for sm_90a.
//
// Replaces (TPU, Pallas):
//   qat_vit_tpu/ops/block_kernel.py::_block_kernel           (K9a: one block
//     per launch, depth = 1 here)
//   qat_vit_tpu/ops/block_kernel.py::_model_resident_kernel  (K9b: every
//     block in one launch, the depth loop in-kernel)
// Both run _block_tile_body: bf16 (or f32) x and int8 zq in, x' and zq' out.
//
// What bounds it on an H100: the same work as the K4 launch chain it fuses
// (ops/block_kernel.py), at ViT-S batch 256 0.224 ms of bytes per block by
// the card's peaks, which the chain's own kernels take ~1.1 ms of device
// time to do. Fusion saves the chain's launch gaps (5 per block in K9a, 60
// per forward in K9b) and keeps the weights in L2; it costs a grid barrier
// and the last wave's idle SMs after each stage, and one block shape for
// all stages.
//
// Design. The five stages of the chain run in order inside one launch, each
// a persistent loop over its own tiles (tile t on block t mod grid), with a
// grid barrier (cooperative_groups) between stages:
//
//   1 qkv   PLAIN, bf16 out   zq    -> qkv  [M, 3D]   int8_gemm_wgmma.cuh (K2a)
//   2 attn  int8 out          qkv   -> o_q  [M, D]    attention_q_mma.cuh (K3)
//   3 proj  RESID_LN_Q        o_q,x -> x_mid f32, zq2 int8_gemm_resid_ln.cuh (K2c)
//   4 fc1   GELU_Q (tanh)     zq2   -> g_q  [M, MLP]  int8_gemm_wgmma.cuh (K2b)
//   5 fc2   RESID_LN_Q        g_q,x_mid -> x', zq'    int8_gemm_resid_ln.cuh (K2c)
//
// Every stage calls the chain kernels' own __device__ code with the chain's
// parameters: the GEMMs accumulate int8 products exactly in int32, so their
// outputs depend only on the epilogue arithmetic (gemm_tile.cuh), which is
// shared; the attention's sums depend on the order of the dots, and the
// stage runs K3's pass code itself. So x' and zq' are the chain's bit for
// bit, at every shape.
//
// One block shape serves all stages: 256 threads, the wgmma GEMM's two
// consumer warpgroups (128-row tiles), on which K3's and K2c's tiles run as
// they do in their own kernels (8 warps). There is no producer warp, since
// every thread must reach every grid barrier: thread 0 starts the GEMM
// stages' TMA copies K9_STAGES - 1 k-steps ahead of the k-step it consumes
// (int8_gemm_wgmma.cuh's SELF form). One kernel holds every stage's
// code, and its registers are the most any stage needs: at two blocks per SM
// (128 registers) it spilled and ran 1.7x slower than at one block per SM
// (255), and a producer warp (288 threads) capped two blocks at 96
// (port_scripts/k9_variants.py, PERF.md). So the grid is one block per SM
// (min(co-resident blocks, K9_MINB) x SMs), with a 4-stage ring, and K2c's
// row tile takes 64 rows where its plan fits the GEMM stages' shared memory
// (32, else 16, for wider D): the rows in flight of the chain's two 32-row
// blocks per SM, with half their re-reads of W. K3's tile keeps K
// and V resident where they fit the same cap, else streams them (the bits
// are the same either way).
//
// The ring (4 stages of 32 KB) and its mbarriers live for the whole launch:
// thread 0 and each consumer warp advance their positions over the same
// (tile, k-step) sequence in the qkv and fc1 stages of every block, so the
// barriers are initialised once. The other stages reuse the ring's shared
// memory; the mbarriers lie past every stage's region.
//
// Proxies. Stage outputs are written by generic stores from other SMs and
// read by TMA (the async proxy) in a later stage, and the ring's shared
// memory is written by generic stores between TMA stages: every thread
// issues fence.proxy.async before each grid barrier.
//
// The per-block parameters (the packed weights' tensor maps, pointers and
// JAX's 12-slot qparam table, as computed for the chain) are one 512-byte
// record per block in device memory (ops/block_kernel.py packs it); the A
// operands' tensor maps are kernel parameters. ViT-S's 21.2 MB of int8
// weights stay in the H100's 50 MB L2 across K9b's blocks, the counterpart
// of the TPU kernel's weights pinned in VMEM, without a cache policy: an
// evict_last / evict_first one measured no different
// (port_scripts/k9_variants.py, PERF.md).

#include <cooperative_groups.h>

#include <algorithm>

#include "attention_q_mma.cuh"
#include "int8_gemm_resid_ln.cuh"
#include "int8_gemm_wgmma.cuh"

// the block shape (port_scripts/k9_variants.py builds the others): blocks
// per SM, ring stages and K2c's most rows per tile
#ifndef QVT_K9_MINB
#define QVT_K9_MINB 1
#endif
#ifndef QVT_K9_STAGES
#define QVT_K9_STAGES 4
#endif
#ifndef QVT_K9_RL_ROWS_MAX
#define QVT_K9_RL_ROWS_MAX 64
#endif

#ifdef QVT_K9_STAMPS
// port_scripts/k9_variants.py: %globaltimer at the start and after each grid
// barrier (block 0; 5 depth + 1 slots), and each block's arrival at each
// grid barrier ([5 depth][grid])
__device__ unsigned long long* k9_stamps;
__device__ unsigned long long* k9_arrivals;
#endif

namespace {

namespace cg = cooperative_groups;
using namespace qvt;
using namespace qvt::gemm;
using qvt_wgmma::Ring;
typedef __nv_bfloat16 bf16;

constexpr int K9_CONS = 2;  // consumer warpgroups: the wgmma GEMM's narrow form
constexpr int K9_STAGES = QVT_K9_STAGES;
constexpr int K9_MINB = QVT_K9_MINB;
using Cfg9 = qvt_wgmma::Cfg<K9_CONS, K9_STAGES>;
constexpr int K9_THREADS = 128 * K9_CONS;  // the consumer warpgroups run every stage
static_assert(K9_THREADS == qvt_attn_q::THREADS && K9_THREADS == qvt_resid_ln::RL_THREADS,
              "the 8 consumer warps run K3's and K2c's tiles");
// H100: the shared memory one block may opt into, and the slack that aligns
// the ring to 1024 bytes
constexpr size_t SMEM_LIMIT = 232448, ALIGN = 1024;
constexpr size_t BAR_BYTES = 2 * 8 * K9_STAGES;

struct GemmW {
  const int8_t* w_t;  // [N, K], packed k-contiguous
  const int32_t* colsum;
  const float* bias;
  const float* wscale;
};

// One block's parameters: the tensor maps of the qkv and fc1 weights, the
// qkv / proj / fc1 / fc2 GEMMs (weights, input scale and zero shift), LN2
// and the next LN, and the output grids of the attention (inv_so, zp_o),
// proj (LN2), fc1 (gelu_q) and fc2 (next LN) stages. ops/block_kernel.py
// packs it with the same layout.
struct BlockTable {
  CUtensorMap w_map[2];
  GemmW g[4];
  const float* ln2_g;
  const float* ln2_b;
  const float* lnn_g;
  const float* lnn_b;
  float ws0[4];
  int ws_pc[4];
  float s_x[4];
  int z_s[4];
  float inv_so, zp_o, inv_s2, zp_2, inv_sg, zp_g, inv_sn, zp_n;
};
static_assert(sizeof(BlockTable) == 512 && alignof(BlockTable) == 64, "BlockTable layout");

struct MegaParams {
  const BlockTable* table;
  int depth;
  const int8_t* zq_in;
  const void* x_in;
  int8_t* zq_out;
  void* x_out;
  bf16* qkv;  // workspace
  int8_t* o_q;
  float* x_mid;
  int8_t* zq2;
  int8_t* g_q;
  int B, N, H, hd, MLP, n_valid;
  int rl_rows, attn_resident, region;  // the plan (Plan below)
  float attn_scale, qmax, eps;
};

// The shared-memory plan of one launch: K2c's rows per tile, K3's form, the
// bytes of the stages' common region (the mbarriers follow it) and of the
// block. ops/block_kernel.megablock_plan mirrors it.
struct Plan {
  int rl_rows;
  bool attn_resident;
  size_t region, smem;
};

constexpr size_t gemm_region() {
  return K9_STAGES * (size_t)Cfg9::STAGE_BYTES +
         K9_CONS * ((size_t)qvt_wgmma::staging_bytes<EPI_PLAIN, bf16>() + 3 * 4 * qvt_wgmma::W_BN);
}
static_assert(qvt_wgmma::staging_bytes<EPI_PLAIN, bf16>() >=
                  qvt_wgmma::staging_bytes<EPI_GELU_Q, int8_t>(),
              "the qkv stage's staging is the larger");

// K2c's tile and K3's form fit the GEMM stages' region where they can
Plan plan(int N, int H, int hd) {
  const size_t cap = gemm_region();
  Plan p{};
  const int D = H * hd;
  p.rl_rows = 16;
  for (int rows = 32; rows <= QVT_K9_RL_ROWS_MAX; rows *= 2)
    if (qvt_resid_ln::rl_smem_bytes(rows, D) <= cap) p.rl_rows = rows;
  const size_t resident = hd <= 64 ? qvt_attn_q::resident_smem<64>(N)
                                   : qvt_attn_q::resident_smem<128>(N);
  const size_t streamed =
      hd <= 64 ? qvt_attn_q::stream_smem<64>() : qvt_attn_q::stream_smem<128>();
  p.attn_resident = resident <= cap;
  const size_t attn = p.attn_resident ? resident : streamed;
  p.region = (std::max({cap, qvt_resid_ln::rl_smem_bytes(p.rl_rows, D), attn}) + 15) / 16 * 16;
  p.smem = ALIGN + p.region + BAR_BYTES;
  return p;
}

__device__ __forceinline__ GemmParams gemm_params(const BlockTable& t, int i, const void* a,
                                                  int M, int N, int K) {
  GemmParams p{};
  p.a = a;
  p.w = t.g[i].w_t;
  p.colsum = t.g[i].colsum;
  p.bias = t.g[i].bias;
  p.wscale = t.g[i].wscale;
  p.M = M;
  p.N = N;
  p.K = K;
  p.ws_per_channel = t.ws_pc[i];
  p.ws0 = t.ws0[i];
  p.s_x = t.s_x[i];
  p.z_s = t.z_s[i];
  return p;
}

#ifdef QVT_K9_STAMPS
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}
#endif

__device__ __forceinline__ void stamp(int& slot) {
#ifdef QVT_K9_STAMPS
  if (blockIdx.x == 0 && threadIdx.x == 0) k9_stamps[slot] = globaltimer();
  ++slot;
#else
  (void)slot;
#endif
}

// every thread's generic writes (global and shared) ordered before the async
// proxy's accesses after the barrier (TMA reads of stage outputs, TMA writes
// into shared memory that other stages wrote), then the grid barrier
__device__ __forceinline__ void stage_barrier(cg::grid_group& grid, int& slot) {
  asm volatile("fence.proxy.async;\n" ::: "memory");
#ifdef QVT_K9_STAMPS
  __syncthreads();  // the block's arrival: its last thread is done with the stage
  if (threadIdx.x == 0) k9_arrivals[(slot - 1) * gridDim.x + blockIdx.x] = globaltimer();
#endif
  grid.sync();
  stamp(slot);
}

// stages 1 and 4: the consumer warpgroups run the tiles; thread 0 fills the
// ring ahead of them
template <int EPI, typename OutT>
__device__ __forceinline__ void gemm_stage(const GemmParams& p, const CUtensorMap* map_a,
                                           const CUtensorMap* map_w, uint8_t* smem,
                                           uint64_t* full, uint64_t* empty, Ring& ring,
                                           Ring& fill) {
  uint8_t* const staging = smem + K9_STAGES * Cfg9::STAGE_BYTES;
  uint8_t* const consts = staging + K9_CONS * qvt_wgmma::staging_bytes<EPI, OutT>();
  qvt_wgmma::wgmma_consume<EPI, OutT, K9_CONS, K9_STAGES, 0, true>(
      p, smem, staging, consts, full, empty, blockIdx.x, gridDim.x, ring, map_a, map_w, &fill);
}

// stage 2: K3's tiles (128 query rows, head, image)
template <int HDP, bool RESIDENT>
__device__ __forceinline__ void attention_stage(const MegaParams& mp, const BlockTable& t,
                                                uint8_t* smem) {
  const int nq = (mp.N + qvt_attn_q::BM - 1) / qvt_attn_q::BM, tiles = nq * mp.H * mp.B;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    qvt_attn_q::attention_q_mma_tile<HDP, true, false, RESIDENT, false>(
        mp.qkv, nullptr, mp.o_q, mp.N, mp.H, mp.hd, mp.n_valid, mp.attn_scale, t.inv_so, t.zp_o,
        mp.qmax, 0.0f, 0.0f, smem, tile % nq, (tile / nq) % mp.H, tile / (nq * mp.H));
    __syncthreads();  // K and V of the next tile overwrite this one's
  }
}

// stages 3 and 5: K2c's row tiles
template <int ROWS, int WM, typename OutT, typename ResT>
__device__ __forceinline__ void resid_ln_rows(const GemmParams& p, uint8_t* smem) {
  for (int tile = blockIdx.x; tile * ROWS < p.M; tile += gridDim.x) {
    qvt_resid_ln::resid_ln_tile<ROWS, WM, OutT, ResT>(p, smem, tile * ROWS);
    __syncthreads();  // the next tile's constants and ring overwrite this one's
  }
}

template <typename OutT, typename ResT>
__device__ __forceinline__ void resid_ln_stage(const GemmParams& p, uint8_t* smem, int rows) {
  if (QVT_K9_RL_ROWS_MAX >= 64 && rows == 64)
    resid_ln_rows<64, 2, OutT, ResT>(p, smem);
  else if (rows == 32)
    resid_ln_rows<32, 2, OutT, ResT>(p, smem);
  else
    resid_ln_rows<16, 1, OutT, ResT>(p, smem);
}

// HDP: the head dim K3's tile is built for (64: hd <= 64, else 128), a
// template argument so that each kernel holds one form's registers
template <typename XT, int HDP>
__global__ void __launch_bounds__(K9_THREADS, K9_MINB)
    megablock_kernel(const __grid_constant__ CUtensorMap map_zq_in,
                     const __grid_constant__ CUtensorMap map_zq_out,
                     const __grid_constant__ CUtensorMap map_zq2, const MegaParams mp) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((1024 - (qvt_wgmma::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + mp.region);
  uint64_t* const empty = full + K9_STAGES;
  cg::grid_group grid = cg::this_grid();
  const int D = mp.H * mp.hd, M = mp.B * mp.N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K9_STAGES; ++s) {
      qvt_wgmma::mbar_init(&full[s], 1);
      qvt_wgmma::mbar_init(&empty[s], 4 * K9_CONS);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int slot = 0;  // QVT_K9_STAMPS: slot 0 the start, slot s + 1 after grid barrier s
  stamp(slot);

  Ring ring, fill;  // the ring's position: consumed, and filled (thread 0)
  for (int j = 0; j < mp.depth; ++j) {
    const BlockTable& t = mp.table[j];
    const int8_t* const zq = j ? mp.zq_out : mp.zq_in;
    const void* const x = j ? mp.x_out : mp.x_in;
    if (j) stage_barrier(grid, slot);  // block j-1's fc2 wrote x and zq

    // 1. qkv: PLAIN, bf16 out
    {
      GemmParams p = gemm_params(t, 0, zq, M, 3 * D, D);
      p.y = mp.qkv;
      gemm_stage<EPI_PLAIN, bf16>(p, j ? &map_zq_out : &map_zq_in, &t.w_map[0], smem, full,
                                  empty, ring, fill);
    }
    stage_barrier(grid, slot);

    // 2. attention, int8 out on the qkv out_q grid
    if (mp.attn_resident)
      attention_stage<HDP, true>(mp, t, smem);
    else
      attention_stage<HDP, false>(mp, t, smem);
    stage_barrier(grid, slot);

    // 3. proj + residual x -> x_mid (f32); LN2 -> zq2
    {
      GemmParams p = gemm_params(t, 1, mp.o_q, M, D, D);
      p.residual = x;
      p.gamma = t.ln2_g;
      p.beta = t.ln2_b;
      p.y = mp.x_mid;
      p.q = mp.zq2;
      p.inv_s = t.inv_s2;
      p.zp = t.zp_2;
      p.qmax = mp.qmax;
      p.eps = mp.eps;
      resid_ln_stage<float, XT>(p, smem, mp.rl_rows);
    }
    stage_barrier(grid, slot);

    // 4. fc1 + tanh-GELU -> g_q
    {
      GemmParams p = gemm_params(t, 2, mp.zq2, M, mp.MLP, D);
      p.q = mp.g_q;
      p.inv_s = t.inv_sg;
      p.zp = t.zp_g;
      p.qmax = mp.qmax;
      gemm_stage<EPI_GELU_Q, int8_t>(p, &map_zq2, &t.w_map[1], smem, full, empty, ring, fill);
    }
    stage_barrier(grid, slot);

    // 5. fc2 + residual x_mid -> x' (the stream type); next LN -> zq'
    {
      GemmParams p = gemm_params(t, 3, mp.g_q, M, D, mp.MLP);
      p.residual = mp.x_mid;
      p.gamma = t.lnn_g;
      p.beta = t.lnn_b;
      p.y = mp.x_out;
      p.q = mp.zq_out;
      p.inv_s = t.inv_sn;
      p.zp = t.zp_n;
      p.qmax = mp.qmax;
      p.eps = mp.eps;
      resid_ln_stage<XT, float>(p, smem, mp.rl_rows);
    }
  }
#ifdef QVT_K9_STAMPS
  stage_barrier(grid, slot);  // the last stage's end
#endif
}

// Error paths clear the runtime's last error, so that a later launch check
// does not report it again.
int fail(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

// Blocks of the kernel that fit on one SM at once (0: none), and the SMs.
template <typename XT, int HDP>
cudaError_t residency(size_t smem, int* per_sm, int* sms) {
  auto kernel = megablock_kernel<XT, HDP>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, K9_THREADS, smem);
}

template <typename XT, int HDP>
int launch(const CUtensorMap (&maps)[3], MegaParams mp, size_t smem, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t e = residency<XT, HDP>(smem, &per_sm, &sms);
  if (e != cudaSuccess) return fail(e);
  if (per_sm < 1) return fail(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {const_cast<CUtensorMap*>(&maps[0]), const_cast<CUtensorMap*>(&maps[1]),
                  const_cast<CUtensorMap*>(&maps[2]), &mp};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(megablock_kernel<XT, HDP>),
                                  dim3(std::min(per_sm, K9_MINB) * sms), dim3(K9_THREADS), args,
                                  smem, stream);
  if (e != cudaSuccess) return fail(e);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The launch's block shape and co-residency for (N, H, hd): out[0] blocks per
// SM of the grid (min(co-resident, K9_MINB)), out[1] SMs, out[2] threads per
// block, out[3] dynamic shared memory bytes, out[4] K2c's rows per tile,
// out[5] 1 where K3's tile keeps K and V resident.
extern "C" int qvt_megablock_residency(int N, int H, int hd, int x_bf16, void* out6) {
  int* out = static_cast<int*>(out6);
  const Plan pl = plan(N, H, hd);
  int per_sm = 0, sms = 0;
  cudaError_t e;
  if (hd <= 64)
    e = x_bf16 ? residency<bf16, 64>(pl.smem, &per_sm, &sms)
               : residency<float, 64>(pl.smem, &per_sm, &sms);
  else
    e = x_bf16 ? residency<bf16, 128>(pl.smem, &per_sm, &sms)
               : residency<float, 128>(pl.smem, &per_sm, &sms);
  if (e != cudaSuccess) return fail(e);
  out[0] = std::min(per_sm, K9_MINB);
  out[1] = sms;
  out[2] = K9_THREADS;
  out[3] = static_cast<int>(pl.smem);
  out[4] = pl.rl_rows;
  out[5] = pl.attn_resident;
  return 0;
}

// The tensor map of one block's packed weight w_t [rows, K] (int8, K a
// multiple of 16, 16-byte aligned) as the wgmma stages read it, encoded on
// the host into out (128 bytes, the BlockTable's w_map slot). Returns a
// cudaError_t.
extern "C" int qvt_megablock_weight_map(const void* w_t, int rows, int K, void* out) {
  if (rows <= 0 || K <= 0 || K % 16 || !aligned16(w_t) ||
      !qvt_wgmma::kmajor_map(static_cast<CUtensorMap*>(out), w_t, rows, K, qvt_wgmma::W_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

#ifdef QVT_K9_STAMPS
extern "C" int qvt_megablock_stamps(void* releases, void* arrivals) {
  cudaError_t e = cudaMemcpyToSymbol(k9_stamps, &releases, sizeof(releases));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(k9_arrivals, &arrivals, sizeof(arrivals));
  return static_cast<int>(e);
}
#endif

// Returns a cudaError_t (0 = launched). table: `depth` BlockTable records in
// device memory (64-byte aligned); zq/x in and out [B, N, D] (x bf16 when
// x_bf16, else f32; the int8 ones 16-byte aligned); the five workspace
// pointers as in MegaParams (zq2 16-byte aligned). D = H hd and MLP
// multiples of 16, hd a multiple of 8 up to 128.
extern "C" int qvt_megablock(const void* table, int depth, const void* zq_in, const void* x_in,
                             void* zq_out, void* x_out, void* qkv, void* o_q, void* x_mid,
                             void* zq2, void* g_q, int B, int N, int H, int hd, int MLP,
                             int n_valid, int x_bf16, float attn_scale, float qmax,
                             float eps, void* stream) {
  const int D = H * hd;
  const Plan pl = plan(N, H, hd);
  if (B <= 0 || N <= 0 || H <= 0 || depth <= 0 || hd <= 0 || hd > 128 || hd % 8 || D % 16 ||
      MLP <= 0 || MLP % 16 || n_valid <= 0 || n_valid > N || pl.smem > SMEM_LIMIT ||
      reinterpret_cast<uintptr_t>(table) % 64 || !aligned16(zq_in) || !aligned16(zq_out) ||
      !aligned16(zq2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * N;
  CUtensorMap maps[3];
  if (!qvt_wgmma::kmajor_map(&maps[0], zq_in, M, D, Cfg9::ROWS) ||
      !qvt_wgmma::kmajor_map(&maps[1], zq_out, M, D, Cfg9::ROWS) ||
      !qvt_wgmma::kmajor_map(&maps[2], zq2, M, D, Cfg9::ROWS))
    return static_cast<int>(cudaErrorInvalidValue);
  MegaParams mp;
  mp.table = static_cast<const BlockTable*>(table);
  mp.depth = depth;
  mp.zq_in = static_cast<const int8_t*>(zq_in);
  mp.x_in = x_in;
  mp.zq_out = static_cast<int8_t*>(zq_out);
  mp.x_out = x_out;
  mp.qkv = static_cast<bf16*>(qkv);
  mp.o_q = static_cast<int8_t*>(o_q);
  mp.x_mid = static_cast<float*>(x_mid);
  mp.zq2 = static_cast<int8_t*>(zq2);
  mp.g_q = static_cast<int8_t*>(g_q);
  mp.B = B;
  mp.N = N;
  mp.H = H;
  mp.hd = hd;
  mp.MLP = MLP;
  mp.n_valid = n_valid;
  mp.rl_rows = pl.rl_rows;
  mp.attn_resident = pl.attn_resident;
  mp.region = static_cast<int>(pl.region);
  mp.attn_scale = attn_scale;
  mp.qmax = qmax;
  mp.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return x_bf16 ? launch<bf16, 64>(maps, mp, pl.smem, s)
                  : launch<float, 64>(maps, mp, pl.smem, s);
  return x_bf16 ? launch<bf16, 128>(maps, mp, pl.smem, s)
                : launch<float, 128>(maps, mp, pl.smem, s);
}
