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
// - one block per (128 query rows, head, image), 8 warps of 16 rows each
//   (the tile's code is attention_q_mma.cuh, which K9's attention stage in
//   megablock.cu runs too, so K9 keeps K3's bits), at
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

#include "attention_q_mma.cuh"

namespace {

using namespace qvt_mma;
using namespace qvt_attn_q;

// SCALE_AFTER (K8): q enters the dot unscaled and the f32 score is scaled
template <int HDP, bool QOUT, bool IN_FQ, bool RESIDENT, bool SCALE_AFTER>
__global__ void __launch_bounds__(THREADS, (MIN_BLOCKS<HDP, RESIDENT>))
    attention_q_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ qs,
                           void* __restrict__ out, int N, int H, int hd, int n_valid, float scale,
                           float inv_s, float zp, float qmax, float fq_min, float fq_max) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  attention_q_mma_tile<HDP, QOUT, IN_FQ, RESIDENT, SCALE_AFTER>(
      qkv, qs, out, N, H, hd, n_valid, scale, inv_s, zp, qmax, fq_min, fq_max, smem_raw,
      blockIdx.x, blockIdx.y, blockIdx.z);
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
