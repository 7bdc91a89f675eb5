"""The bf16 long attention pair on the tensor cores (K5a: qvt_attention_long_mma, K5b:
qvt_attention_long_bwd_mma) on the card: the ptxas register and spill report of both
sources, each kernel against its plain version and the f64 math at eight shapes (ragged
N, n_valid < N, hd 8 to 128, N past the f32 plan), with chip_smoke's bounds and two
launches compared bit for bit, then both timed beside SDPA at [2, 2305, 1728] and
[16, 2305, 1728].

    python3 port_scripts/k5_tc_check.py
"""
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from qat_vit_tpu_torch import _build  # noqa: E402
from qat_vit_tpu_torch.ops import long_attention as la  # noqa: E402

nvcc = _build._nvcc()
for src in ("attention_long_mma.cu", "attention_long_bwd_mma.cu"):
    r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                        str(_build.CSRC / src), "-o", os.devnull], capture_output=True, text=True)
    print(src, r.returncode, "\n".join(l for l in (r.stdout + r.stderr).splitlines()
                                     if "registers" in l or "spill" in l or "error" in l
                                     or "Function properties" in l), flush=True)
print("built in", _build.load().build_seconds, "s", flush=True)
print(cs.card_line(), flush=True)
dev = torch.device("cuda")


def inputs(b, n, h, hd, seed):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * h * hd)).astype(np.float32))
    do = torch.from_numpy(rng.normal(0, 1, (b, n, h * hd)).astype(np.float32))
    return qkv.to(dev).bfloat16(), do.to(dev).bfloat16()


SHAPES = [(2, 197, 6, 64, 197), (2, 300, 3, 32, 290), (1, 130, 2, 128, 130),
          (1, 520, 2, 72, 500), (1, 5, 2, 8, 3), (2, 1000, 4, 32, 1000),
          (1, 2305, 9, 64, 2305), (1, 7000, 1, 64, 6990)]
TIMED = [(2, 2305, 9, 64, 2305), (16, 2305, 9, 64, 2305)]
cases = []
for b, n, h, hd, nv in SHAPES + TIMED:
    qkv, do = inputs(b, n, h, hd, n + hd)
    out, lse = la._attention_launch(qkv, h, hd, nv, want_lse=True)
    timed = (b, n, h, hd, nv) in TIMED
    kw = {"n_valid": nv}
    cases += [
        (f"attention_long_mma [{b}x{n}x{3 * h * hd}] {h}x{hd} n_valid {nv}",
         la.long_attention_qkv, la.long_attention_qkv_plain, (qkv, h, hd), kw, "",
         cs.attention_work(b, n, h, hd), cs.sdpa_forward(torch, qkv, h, hd) if timed else None,
         cs.k5_tc(la, qkv, h, hd, n_valid=nv)),
        (f"attention_long_bwd_mma [{b}x{n}x{3 * h * hd}] {h}x{hd} n_valid {nv}",
         la.long_attention_bwd, la.long_attention_bwd_plain, (qkv, do, h, hd),
         {**kw, "out": out, "lse": lse}, "", cs.attention_work(b, n, h, hd, backward=True),
         cs.sdpa_backward(torch, qkv, do, h, hd) if timed else None,
         cs.k5_tc(la, qkv, h, hd, do, n_valid=nv)),
    ]
res = cs.check_kernels(torch, cases, "k5_tc", slow_plain=(la.long_attention_qkv_plain,
                                                          la.long_attention_bwd_plain))
print("ok", len(res), "cases", flush=True)

# the two passes of K5b apart, and K5a, at batch 16 (device time by kernel name)
b, n, h, hd, nv = TIMED[-1]
qkv, do = inputs(b, n, h, hd, 1)
out, lse = la._attention_launch(qkv, h, hd, nv, want_lse=True)
la.long_attention_bwd(qkv, do, h, hd, out=out, lse=lse)
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    for _ in range(5):
        la._attention_launch(qkv, h, hd, nv, want_lse=True)
        la.long_attention_bwd(qkv, do, h, hd, out=out, lse=lse)
    torch.cuda.synchronize()
times = {}
for e in prof.events():
    if e.device_type == torch.autograd.DeviceType.CUDA:
        times[e.name] = times.get(e.name, 0.0) + e.time_range.elapsed_us() / 5e3
for name, ms in sorted(times.items(), key=lambda kv: -kv[1]):
    print(f"profile [16x2305x1728] {ms:.4f} ms per call: {name}", flush=True)
