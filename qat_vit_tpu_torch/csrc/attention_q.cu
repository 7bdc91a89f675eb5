// Multi-head attention over the packed qkv on the CUDA cores, for sm_90a:
// qvt_flash_attention, output in the qkv type, bf16 or f32, with the f32
// score scaled by hd^-0.5 AFTER the dot (K8). Replaces:
// qat_vit_tpu/ops/flash_attention.py::_attention_kernel. (K3 and the bf16
// kernel A run on the tensor cores, attention_q_mma.cu; the f32 kernel A
// on attention_f32.cu.)
//
// The tile body, its numerics and its design are in attention_tile.cuh
// (shared with megablock.cu). No transposes anywhere: q, k, v are read
// straight from the [B, N, 3*H*hd] qkv GEMM output. The tile pins its
// roundings to its plain version, so kernel and plain outputs are
// bit-identical on the card.
//
// What bounds it on an H100. Per (image, head) it does 4*N*N*hd flops on
// 3*N*hd*el bytes read and N*hd*el written: ~170 flops/byte for ViT-S in
// bf16 (N = 197, hd = 64), compute-bound on the tensor cores in principle.
// This kernel runs both products on the CUDA cores (f32 FMA, 67 TFLOP/s
// peak) and is bound by them and by shared-memory reads. One block per
// (q-tile of 64 queries, head, image); the shared-memory budget bounds N
// where K and V of one head stay whole (f32 doubles them, so K8's gate takes
// the dtype).

#include "attention_tile.cuh"

namespace {

using namespace qvt::attn;

// output in the qkv type (the tile's int8-out form is K9's alone)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    attention_kernel(const T* qkv, void* out, int N, int H, int hd, int n_valid, float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  tile<T, false, true>(qkv, out, N, H, hd, n_valid, scale, 0.0f, 0.0f, 0.0f, smem,
                       blockIdx.x * Q_TILE, blockIdx.y, blockIdx.z);
}

template <typename T>
int launch(const void* qkv, void* out, int B, int N, int H, int hd, int n_valid, float scale,
           void* stream) {
  const size_t smem = smem_bytes(N, hd, sizeof(T));
  auto kernel = attention_kernel<T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + Q_TILE - 1) / Q_TILE, H, B);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), out, N, H, hd, n_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

typedef __nv_bfloat16 bf16;

}  // namespace

// K8: out in the qkv type (is_f32: f32, else bf16); scale is the f32 hd^-0.5
// applied to the f32 score after the dot
extern "C" int qvt_flash_attention(const void* qkv, void* out, int B, int N, int H, int hd,
                                   int n_valid, float scale, int is_f32, void* stream) {
  if (is_f32) return launch<float>(qkv, out, B, N, H, hd, n_valid, scale, stream);
  return launch<bf16>(qkv, out, B, N, H, hd, n_valid, scale, stream);
}
