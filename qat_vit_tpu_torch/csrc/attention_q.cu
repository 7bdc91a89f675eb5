// Multi-head attention over the packed qkv on the CUDA cores, for sm_90a,
// in two forms:
//
// - qvt_attention_fwd: kernel A (K1's forward) for f32 qkv, output in f32,
//   optionally with the qkv activation fake-quant applied to q, k and v as
//   they are loaded. Replaces: qat_vit_tpu/ops/flash_attention.py::
//   _fused_attention_kernel with quantize=False, with and without in_fq, as
//   qat_vit_tpu/ops/flash_attention_train.py's attention_train and
//   attention_train_fq launch it for f32 models. (The bf16 kernel A and K3
//   run on the tensor cores: attention_q_mma.cu.)
// - qvt_flash_attention: output in the qkv type, bf16 or f32, with the f32
//   score scaled by hd^-0.5 AFTER the dot (K8). Replaces:
//   qat_vit_tpu/ops/flash_attention.py::_attention_kernel.
//
// The tile body, its numerics and its design are in attention_tile.cuh
// (shared with megablock.cu). No transposes anywhere: q, k, v are read
// straight from the [B, N, 3*H*hd] qkv GEMM output. The fake-quant's (scale,
// zero point) are read from a device pointer (qs[0], qs[1]): the observer
// that produced them ran on the card in the same step, and the host never
// waits for them. The tile pins its roundings to its plain versions, so
// kernel and plain outputs are bit-identical on the card.
//
// What bounds it on an H100. Per (image, head) it does 4*N*N*hd flops on
// 3*N*hd*el bytes read and N*hd*el written: ~170 flops/byte for ViT-S in
// bf16 (N = 197, hd = 64), compute-bound on the tensor cores in principle.
// This kernel runs both products on the CUDA cores (f32 FMA, 67 TFLOP/s
// peak) and is bound by them and by shared-memory reads. One block per
// (q-tile of 64 queries, head, image); the shared-memory budget bounds N
// where K and V of one head stay whole (f32 doubles them, so K8's gate takes
// the dtype). The f32 kernel A streams K and V in 32-key tiles past that
// budget (attention_tile.cuh's STREAM form, the same bits), so it takes any
// N that JAX's K1 gate admits.

#include "attention_tile.cuh"

namespace {

using namespace qvt::attn;

// output in the qkv type (the tile's int8-out form is K9's alone)
template <typename T, bool IN_FQ, bool SCALE_AFTER, bool STREAM>
__global__ void __launch_bounds__(THREADS)
    attention_kernel(const T* qkv, const float* qs, void* out, int N, int H, int hd,
                     int n_valid, float scale, float fq_min, float fq_max) {
  extern __shared__ __align__(16) uint8_t smem[];
  tile<T, false, IN_FQ, SCALE_AFTER, STREAM>(qkv, qs, out, N, H, hd, n_valid, scale, 0.0f, 0.0f,
                                             0.0f, fq_min, fq_max, smem, blockIdx.x * Q_TILE,
                                             blockIdx.y, blockIdx.z);
}

// STREAM (f32 kernel A past the resident budget): K and V in 32-key tiles
template <typename T, bool IN_FQ, bool SCALE_AFTER, bool STREAM = false>
int launch(const void* qkv, const void* qs, void* out, int B, int N, int H, int hd,
           int n_valid, float scale, float fq_min, float fq_max, void* stream) {
  const size_t smem = STREAM ? stream_smem_bytes(N, hd, sizeof(T)) : smem_bytes(N, hd, sizeof(T));
  auto kernel = attention_kernel<T, IN_FQ, SCALE_AFTER, STREAM>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + Q_TILE - 1) / Q_TILE, H, B);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(qs), out, N, H, hd, n_valid, scale,
      fq_min, fq_max);
  return static_cast<int>(cudaGetLastError());
}

// f32 kernel A: K and V of the head resident where they fit, else streamed
template <bool IN_FQ>
int launch_f32(const void* qkv, const void* qs, void* out, int B, int N, int H, int hd,
               int n_valid, float scale, float fq_min, float fq_max, void* stream) {
  constexpr size_t SMEM_MAX = 232448;  // H100: the dynamic shared memory one block may opt into
  if (smem_bytes(N, hd, sizeof(float)) <= SMEM_MAX)
    return launch<float, IN_FQ, false>(qkv, qs, out, B, N, H, hd, n_valid, scale, fq_min, fq_max,
                                       stream);
  return launch<float, IN_FQ, false, true>(qkv, qs, out, B, N, H, hd, n_valid, scale, fq_min,
                                           fq_max, stream);
}

typedef __nv_bfloat16 bf16;

}  // namespace

// kernel A in f32: out f32; in_fq != 0 fake-quantizes q, k, v with (qs[0],
// qs[1], fq_min, fq_max); scale is hd^-0.5, applied to q before the score dot
extern "C" int qvt_attention_fwd(const void* qkv, const void* qs, void* out, int B, int N,
                                 int H, int hd, int n_valid, float scale, int in_fq,
                                 float fq_min, float fq_max, void* stream) {
  if (in_fq)
    return launch_f32<true>(qkv, qs, out, B, N, H, hd, n_valid, scale, fq_min, fq_max, stream);
  return launch_f32<false>(qkv, nullptr, out, B, N, H, hd, n_valid, scale, 0.0f, 0.0f, stream);
}

// K8: out in the qkv type (is_f32: f32, else bf16); scale is the f32 hd^-0.5
// applied to the f32 score after the dot
extern "C" int qvt_flash_attention(const void* qkv, void* out, int B, int N, int H, int hd,
                                   int n_valid, float scale, int is_f32, void* stream) {
  if (is_f32)
    return launch<float, false, true>(qkv, nullptr, out, B, N, H, hd, n_valid, scale, 0.0f, 0.0f,
                                      stream);
  return launch<bf16, false, true>(qkv, nullptr, out, B, N, H, hd, n_valid, scale, 0.0f, 0.0f,
                                   stream);
}
