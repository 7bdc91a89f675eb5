"""Tuning variants of the pipelined RESID_LN_Q GEMM (K2c, qvt_int8_gemm_resid_ln in
csrc/int8_gemm.cu) timed on the card in one process: each variant is the sources with
text patches, built by its own nvcc into its own library and called through ctypes
with the arguments prepared once (no wrapper on the host path). Each is checked against
the unpatched build (y and q identical; the ablations `no_ln` and `no_epi` are timing
probes only) and timed at the main paths' shapes at every block height that fits:
CUDA events around one call (median of 20) and the device time of the kernel under
torch.profiler, in two rounds of opposite order.

    python3 port_scripts/k2c_variants.py [variant ...]
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

SRC = "int8_gemm.cu"
VARIANTS = {
    "base": [],
    "s4": [("constexpr int RL_STAGES = 3;", "constexpr int RL_STAGES = 4;")],
    "bk128": [("constexpr int RL_BK = 64;", "constexpr int RL_BK = 128;")],
    "nc128": [("constexpr int RL_NC = 192;", "constexpr int RL_NC = 128;")],
    # ablations: no LayerNorm; no global residual load or y store in the epilogue
    "no_ln": [("  for (int lr = warp; lr < BM; lr += RL_THREADS / 32) {",
               "  for (int lr = warp; lr < 0; lr += RL_THREADS / 32) {")],
    "no_epi": [("to_f32(res[(size_t)row * p.N + col])", "0.0f"),
               ("          static_cast<OutT*>(p.y)[(size_t)row * p.N + col] = "
                "from_f32<OutT>(yv[mi][ni][r]);\n", "")],
}
if len(sys.argv) > 1:
    VARIANTS = {k: v for k, v in VARIANTS.items() if k == "base" or k in sys.argv[1:]}
# (label, M, K, N, residual f32, output bf16)
SHAPES = [("OWLv2 fc2 b2", 4610, 3072, 576, True, True),
          ("OWLv2 fc2 b8", 18_440, 3072, 576, True, True),
          ("ViT-S fc2 b32", 6304, 1536, 384, True, True),
          ("ViT-S fc2 b256", 50_432, 1536, 384, True, True),
          ("OWLv2 proj b2", 4610, 576, 576, False, False),
          ("ViT-S proj b32", 6304, 384, 384, False, False)]
SIG = _build._SIGNATURES["qvt_int8_gemm_resid_ln"]


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
                if "resid_ln_kernel" in ln and "Compiling entry" in ln]
        print(f"{name}: resid_ln registers {regs}", flush=True)
        lib = ctypes.CDLL(libs[name])
        lib.qvt_int8_gemm_resid_ln.argtypes = SIG
        lib.qvt_int8_gemm_resid_ln.restype = ctypes.c_int
        out[name] = lib
    return out


def smem(bm, n, patches):
    stages, bk, nc = 3, 64, 192
    for old, new in patches:
        if "RL_STAGES" in old:
            stages = int(new.split("= ")[1].rstrip(";"))
        if "RL_BK" in old:
            bk = int(new.split("= ")[1].rstrip(";"))
        if "RL_NC" in old:
            nc = int(new.split("= ")[1].rstrip(";"))
    return stages * (bm + nc) * (bk + 16) + bm * (n + 4) * 4 + 20 * n


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
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout,
              flush=True)
        for label, m, k, n, res_f32, out_bf16 in SHAPES:
            rng = np.random.default_rng(m + k)
            x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to(dev)
            w = np.clip(np.round(rng.normal(0, 20, (k, n))), -128, 127).astype(np.int8)
            w_t = torch.from_numpy(np.ascontiguousarray(w.T)).to(dev)
            colsum = torch.from_numpy(w.astype(np.int32).sum(0, dtype=np.int32)).to(dev)
            bias = torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)).to(dev)
            res = torch.from_numpy(rng.normal(0, 1.5, (m, n)).astype(np.float32)).to(dev)
            res = res if res_f32 else res.bfloat16()
            gamma = torch.from_numpy(rng.normal(1, 0.2, n).astype(np.float32)).to(dev)
            beta = torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32)).to(dev)
            fns, outs = {}, {}
            for name, lib in libs.items():
                for bm in (64, 32, 16):
                    if smem(bm, n, VARIANTS[name]) > 232448:
                        continue
                    y = torch.empty(m, n, dtype=torch.bfloat16 if out_bf16 else torch.float32,
                                    device=dev)
                    q = torch.empty(m, n, dtype=torch.int8, device=dev)

                    def fn(lib=lib, bm=bm, y=y, q=q):
                        assert lib.qvt_int8_gemm_resid_ln(
                            x.data_ptr(), w_t.data_ptr(), colsum.data_ptr(), bias.data_ptr(),
                            None, res.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                            y.data_ptr(), q.data_ptr(), m, n, k, bm, int(out_bf16),
                            int(not res_f32), 0, 0.002, 0.02, -7, 31.875, 128.0, 255.0,
                            float(np.float32(1e-5)), stream) == 0

                    fn()
                    fns[(name, bm)], outs[(name, bm)] = fn, (y, q)
            torch.cuda.synchronize()
            ref = outs[("base", 64)] if ("base", 64) in outs else outs[("base", 32)]
            times = {key: ([], []) for key in fns}
            for order in (list(fns), list(reversed(fns))):
                for key in order:
                    times[key][0].append(event_ms(fns[key]))
                    times[key][1].append(device_ms(fns[key]))
            for key, (ev, dv) in times.items():
                same = all(torch.equal(a, b) for a, b in zip(outs[key], ref))
                print(f"{label} [{m}x{k}]@[{k}x{n}] {key[0]} rows {key[1]}: events "
                      f"{' / '.join(f'{t:.4f}' for t in ev)} ms, device "
                      f"{' / '.join(f'{t:.4f}' for t in dv)} ms, identical to base {same}",
                      flush=True)


if __name__ == "__main__":
    main()
