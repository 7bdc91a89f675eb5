// Whole ViT blocks in ONE cooperative launch, for sm_90a.
//
// Replaces (TPU, Pallas):
//   qat_vit_tpu/ops/block_kernel.py::_block_kernel           (K9a: one block
//     per launch, depth = 1 here)
//   qat_vit_tpu/ops/block_kernel.py::_model_resident_kernel  (K9b: every
//     block in one launch, the depth loop in-kernel)
// Both run _block_tile_body: bf16 (or f32) x and int8 zq in, x' and zq' out.
//
// Design. The five stages of the K4 launch chain (ops/block_kernel.py) run
// in order inside one launch, each as a grid-stride loop over its tiles,
// separated by cooperative_groups' grid barrier (4 per block, and one more
// between blocks in K9b):
//
//   1 qkv   PLAIN tiled GEMM      zq    -> qkv  bf16 [M, 3D]  (workspace)
//   2 attn  attention tile, int8  qkv   -> o_q  int8 [M, D]
//   3 proj  RESID_LN_Q            o_q,x -> x_mid f32 [M, D], zq2 int8 [M, D]
//   4 fc1   GELU_Q (tanh-GELU)    zq2   -> g_q  int8 [M, MLP]
//   5 fc2   RESID_LN_Q            g_q,x_mid -> x' [M, D], zq' int8 [M, D]
//
// Every stage calls the SAME __device__ tile bodies as the chain's kernels
// (gemm_tile.cuh, attention_tile.cuh) with the same parameters, so x' and
// zq' are bit-identical to the chain by construction. The block has 256
// threads: the attention stage runs one tile on all 8 warps; the GEMM stages
// run two tiles side by side, one on each half of 4 warps (threads 0-127 and
// 128-255), each half with its own shared memory and a named barrier of 128
// threads. The grid is as many blocks as can be co-resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), which a grid
// barrier requires. K9b (hint != 0) loads weight tiles with an L2
// evict_last policy and activation tiles with evict_first: ViT-S's 21.2 MB
// of int8 weights fit the H100's 50 MB L2, the counterpart of the TPU
// kernel's weights pinned in VMEM. The per-block parameters (pointers and
// the 12-slot qparam table, as computed for the chain) are one 256-byte
// record per block in device memory; the activations between stages live
// in one workspace the wrapper allocates (ops/block_kernel.py).
//
// What bounds it on an H100: the same tile work as the chain (int8 tensor
// cores for the GEMMs, the CUDA cores for attention), now behind grid
// barriers and with co-residency capping the grid; what it saves is the 4
// (K9a) or 62 (K9b) launch gaps per block chain and, in K9b, weight refetch
// from HBM.

#include <cooperative_groups.h>

#include "attention_tile.cuh"
#include "gemm_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace qvt::gemm;

struct GemmW {
  const int8_t* w;
  const int32_t* colsum;
  const float* bias;
  const float* wscale;
};

// One block's parameters: the qkv / proj / fc1 / fc2 GEMMs (weights, input
// scale and zero shift), LN2 and the next LN, and the output grids of the
// attention (inv_so, zp_o), proj (LN2), fc1 (gelu_q) and fc2 (next LN)
// stages. ops/block_kernel.py packs it with the same layout.
struct BlockTable {
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
static_assert(sizeof(BlockTable) == 256, "BlockTable layout");

struct MegaParams {
  const BlockTable* table;
  int depth;
  const int8_t* zq_in;
  const void* x_in;
  int8_t* zq_out;
  void* x_out;
  __nv_bfloat16* qkv;  // workspace
  int8_t* o_q;
  float* x_mid;
  int8_t* zq2;
  int8_t* g_q;
  int B, N, H, hd, MLP, n_valid, group_smem;
  float attn_scale, qmax, eps;
};

constexpr int BLOCK_THREADS = qvt::attn::THREADS;  // 256 = two GEMM groups of 128
static_assert(BLOCK_THREADS == 2 * THREADS, "two GEMM groups per block");

__device__ __forceinline__ GemmParams gemm_params(const BlockTable& t, int i, const void* a,
                                                  int M, int N, int K) {
  GemmParams p{};
  p.a = a;
  p.w = t.g[i].w;
  p.colsum = t.g[i].colsum;
  p.bias = t.g[i].bias;
  p.wscale = t.g[i].wscale;
  p.M = M;
  p.N = N;
  p.K = K;
  p.ws_per_channel = t.ws_pc[i];
  p.w_vec = (N % 4 == 0) ? 1 : 0;
  p.ws0 = t.ws0[i];
  p.s_x = t.s_x[i];
  p.z_s = t.z_s[i];
  return p;
}

template <typename XT, bool HINT>
__global__ void __launch_bounds__(BLOCK_THREADS) megablock_kernel(MegaParams mp) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::grid_group grid = cg::this_grid();
  typedef __nv_bfloat16 bf16;
  const int half = threadIdx.x / THREADS;
  const Group grp{static_cast<int>(threadIdx.x % THREADS), 1 + half};
  uint8_t* gsmem = smem + half * mp.group_smem;
  const int workers = gridDim.x * 2, me = blockIdx.x * 2 + half;
  const int D = mp.H * mp.hd, M = mp.B * mp.N;
  const int m_tiles = (M + BM_TILED - 1) / BM_TILED, row_tiles = (M + BM_ROWS - 1) / BM_ROWS;
  const int nq = (mp.N + qvt::attn::Q_TILE - 1) / qvt::attn::Q_TILE;

  for (int j = 0; j < mp.depth; ++j) {
    const BlockTable& t = mp.table[j];
    const int8_t* zq = j ? mp.zq_out : mp.zq_in;
    const void* x = j ? mp.x_out : mp.x_in;
    if (j) grid.sync();  // block j-1's fc2 wrote x and zq

    // 1. qkv: PLAIN, bf16 out
    {
      GemmParams p = gemm_params(t, 0, zq, M, 3 * D, D);
      p.y = mp.qkv;
      const int n_tiles = (3 * D + BN - 1) / BN;
      for (int tile = me; tile < m_tiles * n_tiles; tile += workers)
        tiled_body<EPI_PLAIN, bf16, int8_t, HINT>(p, gsmem, (tile / n_tiles) * BM_TILED,
                                                  (tile % n_tiles) * BN, grp);
    }
    grid.sync();

    // 2. attention, int8 out on the qkv out_q grid: all 8 warps per tile
    for (int tile = blockIdx.x; tile < nq * mp.H * mp.B; tile += gridDim.x) {
      qvt::attn::tile<bf16, true, false>(
          mp.qkv, mp.o_q, mp.N, mp.H, mp.hd, mp.n_valid, mp.attn_scale, t.inv_so, t.zp_o,
          mp.qmax, smem, (tile % nq) * qvt::attn::Q_TILE, (tile / nq) % mp.H,
          tile / (nq * mp.H));
      __syncthreads();  // K and V of the next tile overwrite this one's
    }
    grid.sync();

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
      for (int tile = me; tile < row_tiles; tile += workers)
        resid_ln_body<float, XT, HINT>(p, gsmem, tile * BM_ROWS, grp);
    }
    grid.sync();

    // 4. fc1 + tanh-GELU -> g_q
    {
      GemmParams p = gemm_params(t, 2, mp.zq2, M, mp.MLP, D);
      p.q = mp.g_q;
      p.act = 0;
      p.inv_s = t.inv_sg;
      p.zp = t.zp_g;
      p.qmax = mp.qmax;
      const int n_tiles = (mp.MLP + BN - 1) / BN;
      for (int tile = me; tile < m_tiles * n_tiles; tile += workers)
        tiled_body<EPI_GELU_Q, float, int8_t, HINT>(p, gsmem, (tile / n_tiles) * BM_TILED,
                                                    (tile % n_tiles) * BN, grp);
    }
    grid.sync();

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
      for (int tile = me; tile < row_tiles; tile += workers)
        resid_ln_body<XT, float, HINT>(p, gsmem, tile * BM_ROWS, grp);
    }
  }
}

// Error paths clear the runtime's last error, so that a later launch check
// does not report it again.
int fail(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

// Blocks of the kernel that fit on one SM at once (0: none), and the SMs.
template <typename XT, bool HINT>
cudaError_t residency(size_t smem, int* per_sm, int* sms) {
  auto kernel = megablock_kernel<XT, HINT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, BLOCK_THREADS, smem);
}

template <typename XT, bool HINT>
int launch(MegaParams mp, size_t smem, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t e = residency<XT, HINT>(smem, &per_sm, &sms);
  if (e != cudaSuccess) return fail(e);
  if (per_sm < 1) return fail(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&mp};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(megablock_kernel<XT, HINT>),
                                  dim3(per_sm * sms), dim3(BLOCK_THREADS), args, smem, stream);
  if (e != cudaSuccess) return fail(e);
  return static_cast<int>(cudaGetLastError());
}

// each GEMM group's shared memory (16-byte aligned), and the block's: two
// groups, or one attention tile
int group_smem_bytes(int D) {
  const int r = resid_ln_smem_bytes(D), t = tiled_smem_bytes();
  return ((r > t ? r : t) + 15) / 16 * 16;
}

size_t block_smem_bytes(int N, int H, int hd) {
  const size_t g = 2 * static_cast<size_t>(group_smem_bytes(H * hd));
  const size_t a = qvt::attn::smem_bytes(N, hd, sizeof(__nv_bfloat16));
  return g > a ? g : a;
}

}  // namespace

// How many blocks of the launch below fit on one SM at once, and its grid
// (that times the SMs): a record of the co-residency that caps the grid.
extern "C" int qvt_megablock_residency(int N, int H, int hd, int x_bf16, int hint, void* out2) {
  int* out = static_cast<int*>(out2);
  const size_t smem = block_smem_bytes(N, H, hd);
  cudaError_t e;
  if (x_bf16)
    e = hint ? residency<__nv_bfloat16, true>(smem, &out[0], &out[1])
             : residency<__nv_bfloat16, false>(smem, &out[0], &out[1]);
  else
    e = hint ? residency<float, true>(smem, &out[0], &out[1])
             : residency<float, false>(smem, &out[0], &out[1]);
  return e == cudaSuccess ? 0 : fail(e);
}

// Returns a cudaError_t (0 = launched). table: `depth` BlockTable records in
// device memory; zq/x in and out [B, N, D] (x bf16 when x_bf16, else f32);
// the five workspace pointers as in MegaParams. hint != 0: K9b's L2 policy.
extern "C" int qvt_megablock(const void* table, int depth, const void* zq_in, const void* x_in,
                             void* zq_out, void* x_out, void* qkv, void* o_q, void* x_mid,
                             void* zq2, void* g_q, int B, int N, int H, int hd, int MLP,
                             int n_valid, int x_bf16, int hint, float attn_scale, float qmax,
                             float eps, void* stream) {
  MegaParams mp;
  mp.table = static_cast<const BlockTable*>(table);
  mp.depth = depth;
  mp.zq_in = static_cast<const int8_t*>(zq_in);
  mp.x_in = x_in;
  mp.zq_out = static_cast<int8_t*>(zq_out);
  mp.x_out = x_out;
  mp.qkv = static_cast<__nv_bfloat16*>(qkv);
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
  mp.attn_scale = attn_scale;
  mp.qmax = qmax;
  mp.eps = eps;
  mp.group_smem = group_smem_bytes(H * hd);
  const size_t smem = block_smem_bytes(N, H, hd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return hint ? launch<__nv_bfloat16, true>(mp, smem, s) : launch<__nv_bfloat16, false>(mp, smem, s);
  return hint ? launch<float, true>(mp, smem, s) : launch<float, false>(mp, smem, s);
}
