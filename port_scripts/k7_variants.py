"""Variants of K7 (qvt_quantize_gemm in csrc/int8_gemm_wgmma.cu) timed on the card in
one process.

Each variant is the source with text patches, built by its own nvcc into its own
library and called through ctypes with the arguments prepared once (no Python
wrapper on the host path). At each of the exact path's batch-32 shapes (f32 and
bf16 x, f32 out) every variant is checked against the plain version (outputs
identical) and timed: CUDA events around one call (median of 20) and the device
time under torch.profiler, in two rounds of opposite order; torch._int_mm on the
pre-quantized int8 x is timed beside them. Prints the card's name and power limit
first.

- base: the source as it is (three consumer warpgroups on units of 384 columns,
  min(units, SMs) blocks each taking a share of the (strip, 384 columns) units, so
  a strip is quantized by each block whose run crosses it; Q_LOADS 16-byte loads
  of x in flight per thread);
- cons2: two consumer warpgroups, units of 256 columns;
- loads16: twice as many loads in flight;
- strips: whole 64-row strips per block (one block per strip, at most one per SM)
  where the strips fill half the SMs, so x is quantized once;
- requant: x quantized again for every unit (once per 384 columns);
- rega: the other design, A from registers (REGA below): persistent blocks of
  2 consumer warpgroups on 128 x 128 output tiles; TMA stages float x tiles
  [128 rows x 128 values] (128-byte swizzle) beside W's [128 x 128 bytes];
  each consumer thread loads its A fragment's 16 values per k32 from shared
  memory, quantizes them into 4 registers and issues wgmma with A in
  registers (the PTX ISA takes a register A for .s8). Each x element is read
  (from L2 after the first) and quantized once per 128-column N tile;
- stages2: a W ring of 2 stages;
- ablations, not identical to plain, to show where the time goes: now (the
  producer loads no W, the consumers run wgmma on whatever the ring holds),
  nostore (the epilogue computes and stores nothing), noload (x is not read:
  the strip quantizes a value made from the index).

    python3 port_scripts/k7_variants.py [variant ...]
"""
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
from qat_vit_tpu_torch import _build  # noqa: E402
from qat_vit_tpu_torch.ops import fused_serve as fs  # noqa: E402
from qat_vit_tpu_torch.ops import pallas_gemm as pg  # noqa: E402

SRC = "int8_gemm_wgmma.cu"
_D = ", ".join(f"%{i}" for i in range(64))
_C = ", ".join(f'"+r"(d[{i}])' for i in range(64))
REGA = r"""
// ---- K7 with A in registers (port_scripts/k7_variants.py: rega) ----
constexpr int RA_ROWS = 128;
constexpr int RA_THREADS = 256 + 32;
constexpr int RA_WBYTES = W_BN * W_BK;
template <typename XT> __host__ __device__ constexpr int ra_xbytes() { return RA_ROWS * 128 * (int)sizeof(XT); }
template <typename XT> __host__ __device__ constexpr int ra_box() { return 128 / (int)sizeof(XT); }
template <typename XT> __host__ __device__ constexpr int ra_stages() { return sizeof(XT) == 4 ? 2 : 4; }
template <typename XT> __host__ __device__ constexpr size_t ra_smem() {
  return 1024 + (size_t)ra_stages<XT>() * (ra_xbytes<XT>() + RA_WBYTES) + 2 * 3 * 4 * W_BN +
         2 * 8 * ra_stages<XT>();
}

__device__ __forceinline__ void wgmma_ra(int* d, const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" "@D@" "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : @C@
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <typename XT>
__device__ __forceinline__ uint32_t ra_q4(const uint8_t* src, const GemmParams& p) {
  float f[4];
  if constexpr (sizeof(XT) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    float h[2];
    unpack_word<XT>(v.x, h); f[0] = h[0]; f[1] = h[1];
    unpack_word<XT>(v.y, h); f[2] = h[0]; f[3] = h[1];
  }
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w |= static_cast<uint32_t>(static_cast<uint8_t>(quantize_shifted(f[j], p.a_inv_s, p.a_zp, p.a_qmax))) << (8 * j);
  return w;
}

// the byte address in a stage's x tile of value k (0..127) of tile row r
template <typename XT>
__device__ __forceinline__ int ra_addr(int r, int k) {
  const int b = k / ra_box<XT>(), byte = (k % ra_box<XT>()) * (int)sizeof(XT);
  return b * RA_ROWS * 128 + r * 128 + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
}

template <typename XT, typename OutT>
__global__ void __launch_bounds__(RA_THREADS, 1)
    rega_kernel(const __grid_constant__ CUtensorMap tma_x, const __grid_constant__ CUtensorMap tma_w,
                const GemmParams p) {
  constexpr int S = ra_stages<XT>(), XB = ra_xbytes<XT>(), STAGE = XB + RA_WBYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const consts = ring + S * STAGE;
  uint64_t* const full = reinterpret_cast<uint64_t*>(consts + 2 * 3 * 4 * W_BN);
  uint64_t* const empty = full + S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (p.N + W_BN - 1) / W_BN;
  const int tiles = (p.M + RA_ROWS - 1) / RA_ROWS * n_tiles;
  const int nk = (p.K + W_BK - 1) / W_BK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 8) {
    if (lane != 0) return;
    int stage = 0, phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles) * RA_ROWS, n0 = (t % n_tiles) * W_BN;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], STAGE);
        uint8_t* const st = ring + stage * STAGE;
        for (int b = 0; b < 128 / ra_box<XT>(); ++b)
          tma_load(st + b * RA_ROWS * 128, &tma_x, &full[stage], kt * W_BK + b * ra_box<XT>(), m0);
        tma_load(st + XB, &tma_w, &full[stage], kt * W_BK, n0);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  const int wg = warp >> 2, wtid = tid & 127, wwarp = warp & 3;
  int* const Cs = reinterpret_cast<int*>(consts + wg * 3 * 4 * W_BN);
  float* const Sw = reinterpret_cast<float*>(Cs + W_BN);
  float* const Bi = Sw + W_BN;
  const bool has_bias = p.bias != nullptr;
  const int g = lane >> 2, t4 = lane & 3, rl = 64 * wg + 16 * wwarp + g;
  OutT* const y = static_cast<OutT*>(p.y);
  int stage = 0, phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / n_tiles) * RA_ROWS, n0 = (t % n_tiles) * W_BN;
    int acc[W_BN / 2];
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[stage], phase);
      const uint8_t* const xs = ring + stage * STAGE;
      const uint8_t* const b = xs + XB;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k0 = 32 * kk + 4 * t4;
        a[kk][0] = ra_q4<XT>(xs + ra_addr<XT>(rl, k0), p);
        a[kk][1] = ra_q4<XT>(xs + ra_addr<XT>(rl + 8, k0), p);
        a[kk][2] = ra_q4<XT>(xs + ra_addr<XT>(rl, k0 + 16), p);
        a[kk][3] = ra_q4<XT>(xs + ra_addr<XT>(rl + 8, k0 + 16), p);
      }
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ra(acc, a[kk], sw128_desc(b + 32 * kk), (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    named_sync(1 + wg);
    for (int c = wtid; c < W_BN; c += 128) {
      const int col = n0 + c;
      const bool in = col < p.N;
      Cs[c] = in ? p.colsum[col] : 0;
      Sw[c] = in ? dequant_scale(p, col) : 0.0f;
      Bi[c] = in && has_bias ? p.bias[col] : 0.0f;
    }
    named_sync(1 + wg);
#pragma unroll
    for (int j = 0; j < W_BN / 8; ++j) {
      const int lc = 8 * j + 2 * t4, col = n0 + lc;
      if (col >= p.N) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + rl + 8 * r;
        if (row >= p.M) continue;
        const float y0 = dequant_value(acc[4 * j + 2 * r], p.z_s, Cs[lc], Sw[lc], has_bias, Bi[lc]);
        const float y1 = dequant_value(acc[4 * j + 2 * r + 1], p.z_s, Cs[lc + 1], Sw[lc + 1], has_bias, Bi[lc + 1]);
        store_out(y + (size_t)row * p.N + col, y0, y1, true);
      }
    }
  }
}

template <typename XT, typename OutT>
int launch_rega(const GemmParams& p, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  const cuuint64_t dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.M};
  const cuuint64_t strides[1] = {(cuuint64_t)p.K * sizeof(XT)};
  const cuuint32_t box[2] = {(cuuint32_t)ra_box<XT>(), (cuuint32_t)RA_ROWS};
  const cuuint32_t elem[2] = {1, 1};
  if (enc(&mx, sizeof(XT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
          const_cast<void*>(p.a), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      !kmajor_map(&mw, p.w, p.N, p.K, W_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rega_kernel<XT, OutT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(ra_smem<XT>()));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  cudaGetDevice(&dev);
  const int tiles = (p.M + RA_ROWS - 1) / RA_ROWS * ((p.N + W_BN - 1) / W_BN);
  kernel<<<std::min(tiles, sm_count(dev)), RA_THREADS, ra_smem<XT>(), stream>>>(mx, mw, p);
  return static_cast<int>(cudaGetLastError());
}
""".replace("@D@", _D).replace("@C@", _C)
VARIANTS = {
    "base": [],
    "loads16": [("constexpr int Q_LOADS = 8;", "constexpr int Q_LOADS = 16;")],
    "strips": [("  kernel<<<std::min(units, sms), Q_THREADS, smem, stream>>>",
                "  const int strips = (p.M + Q_ROWS - 1) / Q_ROWS;\n"
                "  kernel<<<strips * 2 >= sms ? std::min(strips, sms) : std::min(units, sms),"
                " Q_THREADS, smem, stream>>>")],
    "requant": [("if (nk > ck || m0 != held) {", "if (true) {")],
    "cons2": [("constexpr int Q_CONS = 3;", "constexpr int Q_CONS = 2;")],
    "stages2": [("constexpr int Q_MAX_STAGES = 4;", "constexpr int Q_MAX_STAGES = 2;")],
    "rega": [("}  // namespace\n\n// y = dequant(a @ w_t^T)", REGA + "}  // namespace\n\n// y = dequant(a @ w_t^T)"),
             ("    return out_bf16 ? launch_quantize_gemm<bf16, bf16>(p, s) : "
              "launch_quantize_gemm<bf16, float>(p, s);\n  return out_bf16 ? "
              "launch_quantize_gemm<float, bf16>(p, s) : launch_quantize_gemm<float, float>(p, s);",
              "    return out_bf16 ? launch_rega<bf16, bf16>(p, s) : launch_rega<bf16, float>(p, s);\n"
              "  return out_bf16 ? launch_rega<float, bf16>(p, s) : launch_rega<float, float>(p, s);")],
    "now": [("        mbar_expect_tx(&full[stage], tiles * W_BN * W_BK);\n"
             "        for (int c = 0; c < tiles; ++c)\n"
             "          tma_load(ring + stage * Q_STAGE_BYTES + c * W_BN * W_BK, &tma_w, &full[stage],\n"
             "                   kt * W_BK, n0 + c * W_BN);",
             "        mbar_arrive(&full[stage]);")],
    "nostore": [("        store_out(dst, y0, y1, even_n);",
                 "        if (y0 == 1.2345e-30f) store_out(dst, y0, y1, even_n);")],
    "noload": [("raw[u][v] = ok ? __ldg(src + v) : make_uint4(0, 0, 0, 0);",
                "raw[u][v] = make_uint4(idx, v, u, k);")],
}
if len(sys.argv) > 1:
    VARIANTS = {k: v for k, v in VARIANTS.items() if k == "base" or k in sys.argv[1:]}
SHAPES = [("patch", 32 * 196, 768, 384), ("qkv", 32 * 197, 384, 1152),
          ("proj", 32 * 197, 384, 384), ("fc1", 32 * 197, 384, 1536),
          ("fc2", 32 * 197, 1536, 384)]
SIG = _build._SIGNATURES["qvt_quantize_gemm"]


def build_all(tmp):
    nvcc, procs, libs = _build._nvcc(), [], {}
    for name, patches in VARIANTS.items():
        d = os.path.join(tmp, name)
        shutil.copytree(_build.CSRC, d)
        p = os.path.join(d, SRC)
        text = open(p).read()
        for old, new in patches:
            assert old in text, (name, old)
            text = text.replace(old, new)
        open(p, "w").write(text)
        libs[name] = os.path.join(d, "lib.so")
        procs.append(subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", d, "-o", libs[name], p],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for name, proc in zip(VARIANTS, procs):
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: {err[-3000:]}")
        lines = err.splitlines()
        regs = [next(x for x in lines[i:] if "Used " in x).split("Used ")[1].split(",")[0]
                for i, ln in enumerate(lines)
                if ("quantize_gemm_kernel" in ln or "rega_kernel" in ln) and "Compiling" in ln]
        spills = sorted({x.strip() for x in lines if "spill" in x and not x.strip().startswith(
            "0 bytes spill")})
        print(f"{name}: registers {regs} {'; '.join(spills) or 'no spills'}", flush=True)
        lib = ctypes.CDLL(libs[name])
        lib.qvt_quantize_gemm.argtypes = SIG
        lib.qvt_quantize_gemm.restype = ctypes.c_int
        out[name] = lib
    return out


def device_ms(fn, runs=20):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / runs


def event_ms(fn, runs=20):
    for _ in range(3):
        fn()
    ts = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def main():
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    s_x, zp = 4.0 / 255, 100.0
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        for label, m, k, n in SHAPES:
            for x_dt in (torch.float32, torch.bfloat16):
                rng = np.random.default_rng(m + k + n)
                x = torch.from_numpy(rng.normal(0, 1.5, (m, k)).astype(np.float32)).to(dev)
                x = x.to(x_dt)
                w = np.clip(np.round(rng.normal(0, 20, (k, n))), -128, 127).astype(np.int8)
                layer = fs.with_packed_weight({
                    "w_int8": torch.from_numpy(w).to(dev),
                    "w_colsum": torch.from_numpy(w.astype(np.int32).sum(0, dtype=np.int32)).to(
                        dev),
                    "bias": torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)).to(dev),
                    "w_scale": torch.tensor(0.002)})
                want = pg.fused_quantize_matmul_plain(
                    x, layer["w_int8"], x_scale=s_x, x_zero_point=zp, w_scale=0.002,
                    w_colsum=layer["w_colsum"], bias=layer["bias"])
                fns, outs = {}, {}
                for name, lib in libs.items():
                    y = torch.empty(m, n, device=dev)

                    def fn(lib=lib, y=y):
                        return lib.qvt_quantize_gemm(
                            x.data_ptr(), layer["w_int8_t"].data_ptr(),
                            layer["w_colsum"].data_ptr(), layer["bias"].data_ptr(), None,
                            y.data_ptr(), m, n, k, int(x_dt == torch.bfloat16), 0, 0, 0.002,
                            float(np.float32(s_x)), int(zp) - 128, fs.inv_scale(s_x), zp, 255.0,
                            stream)

                    assert fn() == 0, name
                    fns[name], outs[name] = fn, y
                torch.cuda.synchronize()
                x_q = fs.quantize_mul(x.float(), fs.inv_scale(s_x), zp, 255.0)
                wc = layer["w_int8"].t().contiguous().t()
                lib_ev = event_ms(lambda: torch._int_mm(x_q, wc))
                lib_dev = device_ms(lambda: torch._int_mm(x_q, wc))
                times = {key: ([], []) for key in fns}
                for order in (list(fns), list(reversed(fns))):
                    for key in order:
                        times[key][0].append(event_ms(fns[key]))
                        times[key][1].append(device_ms(fns[key]))
                dt = "f32" if x_dt == torch.float32 else "bf16"
                for key, (ev, dv) in times.items():
                    print(f"K7 {label} [{m}x{k}]@[{k}x{n}] {dt} in {key}: events "
                          f"{' / '.join(f'{t:.4f}' for t in ev)} ms, device "
                          f"{' / '.join(f'{t:.4f}' for t in dv)} ms, identical to plain "
                          f"{torch.equal(outs[key], want)}", flush=True)
                print(f"K7 {label} [{m}x{k}]@[{k}x{n}] {dt} in torch._int_mm: events "
                      f"{lib_ev:.4f} ms, device {lib_dev:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
