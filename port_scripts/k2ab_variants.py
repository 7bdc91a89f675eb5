"""Tile and stage variants of the TMA + wgmma int8 GEMM (K2a PLAIN / PLAIN_Q8, K2b
GELU_Q: qvt_int8_gemm in csrc/int8_gemm_wgmma.cu) timed on the card in one process.

Each variant is the source with text patches (W_CONSUMERS, W_STAGES and their narrow
form), built by its own nvcc into its own library and called through ctypes with the
arguments prepared once (no Python wrapper on the host path). At each shape every variant is checked against the
plain version (the outputs identical) and timed: CUDA events around one call (median of
20) and the device time of the kernel under torch.profiler, in two rounds of opposite
order; torch._int_mm on the same operands is timed beside them. A variant whose shared
memory does not fit is reported as refused. Prints the card's name and power limit first.

    python3 port_scripts/k2ab_variants.py [variant ...]
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

SRC = "int8_gemm_wgmma.cu"


def cfg(cons=4, stages=3, narrow=(2, 4)):
    """The text patches that set the source's tile constants (defaults: the chosen ones)."""
    return [("constexpr int W_CONSUMERS = 4;", f"constexpr int W_CONSUMERS = {cons};"),
            ("constexpr int W_STAGES = 3;", f"constexpr int W_STAGES = {stages};"),
            ("constexpr int W_NARROW_CONSUMERS = 2;",
             f"constexpr int W_NARROW_CONSUMERS = {narrow[0]};"),
            ("constexpr int W_NARROW_STAGES = 4;", f"constexpr int W_NARROW_STAGES = {narrow[1]};")]


# name -> patches. base: 4 consumer warpgroups x 3 stages where the output staging
# fits (PLAIN bf16, GELU_Q), else 2 x 4 (PLAIN f32, PLAIN_Q8); the others set one
# shape for every epilogue: the first design (2 x 4), its stage variants, 3 and 4
# warpgroups. (The tile widths 64 / 192 / 256, ping-pong warpgroups and two blocks
# per SM were measured on earlier forms of the source and left it; PERF.md.)
VARIANTS = {
    "base": [],
    "wg2_s4": cfg(2, 4),
    "wg2_s3": cfg(2, 3, narrow=(2, 3)),
    "wg2_s5": cfg(2, 5, narrow=(2, 5)),
    "wg3_s4": cfg(3, 4),
    "wg4_s2": cfg(4, 2),
}
if len(sys.argv) > 1:
    VARIANTS = {k: v for k, v in VARIANTS.items() if k == "base" or k in sys.argv[1:]}
# (label, M, K, N, epilogue, act): ViT-S at batch 32 and 256, OWLv2-pruned at batch 8
SHAPES = [("ViT-S qkv b32", 6304, 384, 1152, fs.EPI_PLAIN, "gelu"),
          ("ViT-S fc1 b32", 6304, 384, 1536, fs.EPI_GELU_Q, "gelu"),
          ("ViT-S patch b32", 6272, 768, 384, fs.EPI_PLAIN, "gelu"),
          ("ViT-S qkv b256", 50_432, 384, 1152, fs.EPI_PLAIN, "gelu"),
          ("ViT-S fc1 b256", 50_432, 384, 1536, fs.EPI_GELU_Q, "gelu"),
          ("ViT-S patch b256", 50_176, 768, 384, fs.EPI_PLAIN, "gelu"),
          ("OWLv2 qkv q8 b8", 18_440, 576, 1728, fs.EPI_PLAIN_Q8, "gelu"),
          ("OWLv2 fc1 b8", 18_440, 576, 3072, fs.EPI_GELU_Q, "quick_gelu")]
SIG = _build._SIGNATURES["qvt_int8_gemm"]


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
                for i, ln in enumerate(lines) if "int8_wgmma_kernel" in ln and "Compiling" in ln]
        spills = sorted({x.strip() for x in lines if "spill" in x and not x.strip().startswith(
            "0 bytes spill")})
        print(f"{name}: registers {regs} {'; '.join(spills) or 'no spills'}", flush=True)
        lib = ctypes.CDLL(libs[name])
        lib.qvt_int8_gemm.argtypes = SIG
        lib.qvt_int8_gemm.restype = ctypes.c_int
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
    in_q = {"scale": torch.tensor(0.02), "zero_point": torch.tensor(121.0)}
    out_q = {"scale": torch.tensor(4.0 / 255), "zero_point": torch.tensor(11.0)}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        for label, m, k, n, epi, act in SHAPES:
            rng = np.random.default_rng(m + k + n)
            x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to(dev)
            w = np.clip(np.round(rng.normal(0, 20, (k, n))), -128, 127).astype(np.int8)
            layer = fs.with_packed_weight({
                "w_int8": torch.from_numpy(w).to(dev),
                "w_colsum": torch.from_numpy(w.astype(np.int32).sum(0, dtype=np.int32)).to(dev),
                "bias": torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)).to(dev),
                "w_scale": torch.tensor(0.002)})
            q_n = 2 * n // 3 if epi == fs.EPI_PLAIN_Q8 else n
            if epi == fs.EPI_GELU_Q:
                want = (None, fs.int8_dense_gelu_q_plain(x, layer, in_q, out_q, act=act))
            elif epi == fs.EPI_PLAIN_Q8:
                want = fs.int8_dense_q8_plain(x, layer, in_q, out_q)
            else:
                want = (fs.int8_dense_plain(x, layer, in_q), None)
            fns, outs, refused = {}, {}, []
            for name, lib in libs.items():
                y = torch.empty(m, n, dtype=torch.bfloat16, device=dev) if epi != fs.EPI_GELU_Q else None
                q = torch.empty(m, q_n, dtype=torch.int8, device=dev) if epi != fs.EPI_PLAIN else None

                def fn(lib=lib, y=y, q=q):
                    return lib.qvt_int8_gemm(
                        x.data_ptr(), layer["w_int8_t"].data_ptr(), layer["w_colsum"].data_ptr(),
                        layer["bias"].data_ptr(), None, None if y is None else y.data_ptr(),
                        None if q is None else q.data_ptr(), m, n, k, epi, 1, 0,
                        {"gelu": 0, "quick_gelu": 1}[act], 0.002, 0.02, 121 - 128,
                        fs.inv_scale(out_q["scale"]), 11.0, 255.0, q_n, stream)

                if fn() != 0:
                    refused.append(name)
                    continue
                fns[name], outs[name] = fn, (y, q)
            torch.cuda.synchronize()
            wc = layer["w_int8"].t().contiguous().t()
            lib_ev = event_ms(lambda: torch._int_mm(x, wc))
            lib_dev = device_ms(lambda: torch._int_mm(x, wc))
            times = {key: ([], []) for key in fns}
            for order in (list(fns), list(reversed(fns))):
                for key in order:
                    times[key][0].append(event_ms(fns[key]))
                    times[key][1].append(device_ms(fns[key]))
            for key, (ev, dv) in times.items():
                same = all(g is None or torch.equal(g, w_) for g, w_ in zip(outs[key], want))
                print(f"{label} [{m}x{k}]@[{k}x{n}] {key}: events "
                      f"{' / '.join(f'{t:.4f}' for t in ev)} ms, device "
                      f"{' / '.join(f'{t:.4f}' for t in dv)} ms, identical to plain {same}",
                      flush=True)
            print(f"{label} [{m}x{k}]@[{k}x{n}] torch._int_mm: events {lib_ev:.4f} ms, device "
                  f"{lib_dev:.4f} ms" + (f"; refused (shared memory): {', '.join(refused)}"
                                         if refused else ""), flush=True)


if __name__ == "__main__":
    main()
