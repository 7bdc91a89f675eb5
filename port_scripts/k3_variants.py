"""Layout variants of the short-sequence attention (csrc/attention_q_mma.cu: K3 and
the bf16 kernel A) timed on the card in one process: each variant is the source with
one text patch, built by its own nvcc into its own library (registers and spills
printed), checked against the unpatched build (K3's identical share, kernel A's rel
L2) and timed at ViT-S [32, 197, 1152] and [256, 197, 1152] (CUDA events around 10
back-to-back calls, median of 20, two rounds in opposite orders).

    python3 port_scripts/k3_variants.py [VARIANT ...]
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

SRC = "attention_q_mma.cu"
STREAM = "constexpr size_t SMEM_MAX = 232448;", "constexpr size_t SMEM_MAX = 0;"
W = "constexpr int WARPS = 8;"
VARIANTS = {
    "base": [],  # 8 warps, 128 query rows per block, K and V resident
    "w2": [(W, "constexpr int WARPS = 2;")],  # 32 rows
    "w4": [(W, "constexpr int WARPS = 4;")],  # 64 rows
    "w16": [(W, "constexpr int WARPS = 16;")],  # 256 rows: one block per head at N 197
    "stream": [STREAM],  # K and V through the 64-key cp.async ring at any N
    "w4_stream": [(W, "constexpr int WARPS = 4;"), STREAM],
}
if len(sys.argv) > 1:
    VARIANTS = {k: v for k, v in VARIANTS.items() if k == "base" or k in sys.argv[1:]}
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_all(tmp):
    nvcc, cmds, libs = _build._nvcc(), [], {}
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
        cmds.append([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", d, "-o",
                     libs[name], p])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    for name, p in zip(VARIANTS, procs):
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: {err[-2000:]}")
        regs = [ln.split("Used ")[1].split(",")[0] for ln in err.splitlines() if "Used " in ln]
        spills = [ln.strip() for ln in err.splitlines()
                  if "spill" in ln and " 0 bytes spill" not in ln]
        print(f"{name}: registers {regs} {spills}", flush=True)
    out = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        for fn in ("qvt_attention_q_mma", "qvt_attention_fwd_mma"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        out[name] = lib
    return out


def main():
    dev = torch.device("cuda")
    h, hd, n = 6, 64, 197
    qscale = float(torch.tensor(hd ** -0.5, dtype=torch.bfloat16))
    qs = torch.tensor([4.2 / 255, 127.0], dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout,
              flush=True)
        for b in (32, 256):
            rng = np.random.default_rng(b)
            qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * h * hd)).astype(np.float32))
            qkv = qkv.to(dev).bfloat16()
            calls, outs = {}, {}
            for name, lib in libs.items():
                o8 = torch.empty(b, n, h * hd, dtype=torch.int8, device=dev)
                o16 = torch.empty(b, n, h * hd, dtype=torch.bfloat16, device=dev)
                o16f = torch.empty_like(o16)

                def k3(lib=lib, o8=o8):
                    assert lib.qvt_attention_q_mma(qkv.data_ptr(), o8.data_ptr(), b, n, h, hd,
                                                   n, qscale, fs.inv_scale(8.0 / 255), 128.0,
                                                   255.0, stream) == 0

                def a(lib=lib, o16=o16):
                    assert lib.qvt_attention_fwd_mma(qkv.data_ptr(), None, o16.data_ptr(), b, n,
                                                     h, hd, n, qscale, 0, 0.0, 0.0, stream) == 0

                def a_fq(lib=lib, o16f=o16f):
                    assert lib.qvt_attention_fwd_mma(qkv.data_ptr(), qs.data_ptr(),
                                                     o16f.data_ptr(), b, n, h, hd, n, qscale, 1,
                                                     0.0, 255.0, stream) == 0

                for fn in (k3, a, a_fq):
                    fn()
                torch.cuda.synchronize()
                calls[name], outs[name] = (k3, a, a_fq), (o8, o16, o16f)
            base = outs["base"]
            for name, (o8, o16, o16f) in outs.items():
                rel = lambda x, r: float((x.double() - r.double()).norm() / r.double().norm())  # noqa
                print(f"b {b} {name}: K3 identical share vs base "
                      f"{float((o8 == base[0]).float().mean()):.7f}, A rel L2 "
                      f"{rel(o16, base[1]):.3e}, A in_fq {rel(o16f, base[2]):.3e}", flush=True)
            times = {name: ([], [], []) for name in calls}
            for order in (list(calls), list(reversed(calls))):
                for name in order:
                    for k, fn in enumerate(calls[name]):
                        for _ in range(3):
                            fn()
                        ts = []
                        for _ in range(20):
                            s = torch.cuda.Event(enable_timing=True)
                            e = torch.cuda.Event(enable_timing=True)
                            s.record()
                            for _ in range(10):
                                fn()
                            e.record()
                            e.synchronize()
                            ts.append(s.elapsed_time(e) / 10)
                        times[name][k].append(statistics.median(ts))
            for name, ts in times.items():
                print(f"b {b} {name}: " + ", ".join(
                    f"{label} {' / '.join(f'{t:.4f}' for t in tt)} ms"
                    for label, tt in zip(("K3", "A", "A in_fq"), ts)), flush=True)


if __name__ == "__main__":
    main()
