"""Tuning variants of the bf16 long attention pair (K5a attention_long_mma.cu, K5b
attention_long_bwd_mma.cu) timed on the card in one process: each variant is the
sources with one text patch, built by its own nvcc into its own library, checked
against the unpatched build (rel L2 of out and dqkv) and timed at [16, 2305, 1728]
(CUDA events, median of 20, two rounds in opposite orders).

    python3 port_scripts/k5_variants.py
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

FWD, BWD = "attention_long_mma.cu", "attention_long_bwd_mma.cu"
# name -> [(file, text, replacement)]
W4 = "constexpr int WARPS = 8;", "constexpr int WARPS = 4;"
S2 = "constexpr int STAGES = HDP <= 64 ? 3 : 2;", "constexpr int STAGES = 2;"
NO_CAP = ("constexpr int MIN_BLOCKS = HDP <= 64 ? 512 / THREADS : 1;",
          "constexpr int MIN_BLOCKS = 1;")
VARIANTS = {
    "base": [],
    "w4": [(FWD, *W4), (BWD, *W4)],  # 4 warps, 64 rows (keys) per block
    "s2": [(FWD, *S2), (BWD, *S2)],  # two cp.async stages at hd 64
    "no_cap": [(FWD, *NO_CAP), (BWD, *NO_CAP)],  # the compiler's register count
}
if len(sys.argv) > 1:
    VARIANTS = {k: v for k, v in VARIANTS.items() if k == "base" or k in sys.argv[1:]}


def build_all(tmp):
    nvcc, cmds, libs = _build._nvcc(), [], {}
    for name, patches in VARIANTS.items():
        d = os.path.join(tmp, name)
        shutil.copytree(_build.CSRC, d)
        for f, old, new in patches:
            p = os.path.join(d, f)
            text = open(p).read()
            assert old in text, (name, f, old)
            open(p, "w").write(text.replace(old, new))
        libs[name] = os.path.join(d, "lib.so")
        cmds.append([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", d, "-o",
                     libs[name], os.path.join(d, FWD), os.path.join(d, BWD)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    for name, p in zip(VARIANTS, procs):
        out, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: {err[-2000:]}")
        regs = [ln.split("Used ")[1].split(",")[0] for ln in err.splitlines() if "Used " in ln]
        spills = [ln.strip() for ln in err.splitlines() if "spill" in ln and " 0 bytes spill" not in ln]
        print(f"{name}: registers {regs} {spills}", flush=True)
    out = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        for fn in ("qvt_attention_long_mma", "qvt_attention_long_bwd_mma"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        out[name] = lib
    return out


def main():
    dev = torch.device("cuda")
    b, n, h, hd = 16, 2305, 9, 64
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * h * hd)).astype(np.float32)).to(dev).bfloat16()
    do = torch.from_numpy(rng.normal(0, 1, (b, n, h * hd)).astype(np.float32)).to(dev).bfloat16()
    qscale = float(torch.tensor(hd ** -0.5, dtype=torch.bfloat16))
    scale = float(np.float32(hd ** -0.5))
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout,
              flush=True)
        bufs = {}
        for name, lib in libs.items():
            out = torch.empty(b, n, h * hd, dtype=torch.bfloat16, device=dev)
            lse = torch.empty(b, h, n, dtype=torch.float32, device=dev)
            dsum = torch.empty_like(lse)
            qsc = torch.empty_like(out)
            dqkv = torch.empty_like(qkv)

            def fwd(lib=lib, out=out, lse=lse):
                assert lib.qvt_attention_long_mma(qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                                  b, n, h, hd, n, qscale, stream) == 0

            def bwd(lib=lib, out=out, lse=lse, dsum=dsum, qsc=qsc, dqkv=dqkv):
                assert lib.qvt_attention_long_bwd_mma(
                    qkv.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    dsum.data_ptr(), qsc.data_ptr(), dqkv.data_ptr(), b, n, h, hd, n, qscale,
                    scale, stream) == 0

            fwd()
            bwd()
            torch.cuda.synchronize()
            bufs[name] = (fwd, bwd, out, dqkv)
        _, _, out0, dq0 = bufs["base"]
        for name, (_, _, out, dqkv) in bufs.items():
            rel = lambda a, r: float((a.double() - r.double()).norm() / r.double().norm())  # noqa
            print(f"{name}: out rel L2 vs base {rel(out, out0):.3e}, dqkv {rel(dqkv, dq0):.3e}",
                  flush=True)
        times = {name: ([], []) for name in bufs}
        for order in (list(bufs), list(reversed(bufs))):
            for name in order:
                for k, fn in enumerate(bufs[name][:2]):
                    for _ in range(3):
                        fn()
                    ts = []
                    for _ in range(20):
                        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        s.record()
                        fn()
                        e.record()
                        e.synchronize()
                        ts.append(s.elapsed_time(e))
                    times[name][k].append(statistics.median(ts))
        for name, (tf, tb) in times.items():
            print(f"{name}: K5a {' / '.join(f'{t:.4f}' for t in tf)} ms, K5b "
                  f"{' / '.join(f'{t:.4f}' for t in tb)} ms", flush=True)


if __name__ == "__main__":
    main()
