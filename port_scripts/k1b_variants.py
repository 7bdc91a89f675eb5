"""Layout variants of the bf16 kernel B (csrc/attention_bwd_mma.cu) timed on the card
in one process: each variant is the source with one text patch, built by its own nvcc
into its own library (registers and spills printed), checked against the unpatched
build (rel L2 of dqkv) and timed at ViT-S [32, 197, 1152] and [256, 197, 1152] with
in_fq off and on (CUDA events around 10 back-to-back calls, median of 20, two rounds
in opposite orders).

    python3 port_scripts/k1b_variants.py [VARIANT ...]
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

SRC = "attention_bwd_mma.cu"
W = "constexpr int WARPS = 8;"
BN = "constexpr int BN = 32;"
QT = "constexpr int QT = 32;"
VARIANTS = {
    "base": [],  # 8 warps, 128-row blocks, 32-key tiles (rows), 32-query tiles (keys)
    "bn64": [(BN, "constexpr int BN = 64;")],  # 64-key tiles in the rows pass
    "bn16": [(BN, "constexpr int BN = 16;")],
    "qt16": [(QT, "constexpr int QT = 16;")],  # 16-query tiles in the keys pass
    "qt64": [(QT, "constexpr int QT = 64;")],
    "w4": [(W, "constexpr int WARPS = 4;")],  # 64-row blocks in both passes
    "stream": [("constexpr size_t SMEM_MAX = 232448;", "constexpr size_t SMEM_MAX = 0;")],
}
if len(sys.argv) > 1:
    VARIANTS = {k: v for k, v in VARIANTS.items() if k == "base" or k in sys.argv[1:]}
ENTRY = "qvt_attention_bwd_mma"


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
        getattr(lib, ENTRY).argtypes = _build._SIGNATURES[ENTRY]
        getattr(lib, ENTRY).restype = ctypes.c_int
        out[name] = lib
    return out


def main():
    dev = torch.device("cuda")
    h, hd, n = 6, 64, 197
    scale = float(np.float32(hd ** -0.5))
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
            do = torch.from_numpy(rng.normal(0, 1, (b, n, h * hd)).astype(np.float32))
            do = do.to(dev).bfloat16()
            stats = torch.empty(2, b, h, n, device=dev)
            calls, outs = {}, {}
            for name, lib in libs.items():
                o = torch.empty_like(qkv)
                of = torch.empty_like(qkv)

                def plain(lib=lib, o=o):
                    assert getattr(lib, ENTRY)(qkv.data_ptr(), do.data_ptr(), None,
                                               stats.data_ptr(), o.data_ptr(), b, n, h, hd, n,
                                               scale, 0, 0.0, 0.0, stream) == 0

                def fq(lib=lib, of=of):
                    assert getattr(lib, ENTRY)(qkv.data_ptr(), do.data_ptr(), qs.data_ptr(),
                                               stats.data_ptr(), of.data_ptr(), b, n, h, hd, n,
                                               scale, 1, 0.0, 255.0, stream) == 0

                for fn in (plain, fq):
                    fn()
                torch.cuda.synchronize()
                calls[name], outs[name] = (plain, fq), (o, of)
            base = outs["base"]
            for name, (o, of) in outs.items():
                rel = lambda x, r: float((x.double() - r.double()).norm() / r.double().norm())  # noqa
                print(f"b {b} {name}: dqkv rel L2 vs base {rel(o, base[0]):.3e}, in_fq "
                      f"{rel(of, base[1]):.3e}", flush=True)
            times = {name: ([], []) for name in calls}
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
                    for label, tt in zip(("B", "B in_fq+ste"), ts)), flush=True)


if __name__ == "__main__":
    main()
