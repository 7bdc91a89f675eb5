"""K5b (the long attention backward) on the card: ptxas report, kernel vs plain at five
shapes, K5a and K5b times at batch 2 and 16, the autograd pair vs the plain versions.

    python3 port_scripts/k5b_check.py
"""
import os, subprocess, sys, time
import numpy as np
import torch
sys.path.insert(0, os.getcwd())
from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops import long_attention as la
from qat_vit_tpu_torch.ops._cuda import reference_impl

nvcc = _build._nvcc()
r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                    str(_build.CSRC / "attention_long_bwd.cu"), "-o", os.devnull],
                   capture_output=True, text=True)
print(r.stdout[-3000:], r.stderr[-3000:], flush=True)
lib = _build.load()
print("built", lib.build_seconds, flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout, flush=True)
dev = torch.device("cuda")
ok = True
for b, n, h, hd, nv in [(2, 197, 6, 64, 197), (2, 300, 3, 32, 290), (1, 130, 2, 128, 130),
                        (1, 520, 2, 72, 500), (2, 2305, 9, 64, 2305)]:
    rng = np.random.default_rng(n + hd)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * h * hd)).astype(np.float32)).to(dev).bfloat16()
    do = torch.from_numpy(rng.normal(0, 1, (b, n, h * hd)).astype(np.float32)).to(dev).bfloat16()
    got = la.long_attention_bwd(qkv, do, h, hd, n_valid=nv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = la.long_attention_bwd_plain(qkv, do, h, hd, n_valid=nv)
    torch.cuda.synchronize()
    tp = time.perf_counter() - t0
    d = (got.float() - want.float()).abs()
    same = torch.equal(got, want)
    ok &= same
    print(f"[{b},{n},{h},{hd}] n_valid {nv}: identical {same} max|diff| {float(d.max()):.3e} "
          f"n_diff {int((d > 0).sum())} of {d.numel()} max|want| {float(want.float().abs().max()):.3e} "
          f"plain {tp:.2f} s", flush=True)
    if not same:
        idx = (d > 0).nonzero()[:10]
        print(idx.tolist(), flush=True)

for b in (2, 16):
    rng = np.random.default_rng(b)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, 2305, 1728)).astype(np.float32)).to(dev).bfloat16()
    do = torch.from_numpy(rng.normal(0, 1, (b, 2305, 576)).astype(np.float32)).to(dev).bfloat16()
    for _ in range(2):
        la.long_attention_bwd(qkv, do, 9, 64)
    st, en = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    st.record()
    for _ in range(3):
        la.long_attention_bwd(qkv, do, 9, 64)
    en.record(); en.synchronize()
    ms = st.elapsed_time(en) / 3
    st.record()
    for _ in range(3):
        la.long_attention_qkv(qkv, 9, 64)
    en.record(); en.synchronize()
    fms = st.elapsed_time(en) / 3
    print(f"batch {b}: K5b {ms:.2f} ms ({14 * b * 9 * 2305**2 * 64 / ms / 1e9:.2f} TFLOP/s of 14 N^2 hd), K5a {fms:.2f} ms", flush=True)

# autograd pair vs reference_impl
rng = np.random.default_rng(5)
qkv = torch.from_numpy(rng.normal(0, 1, (2, 700, 3 * 3 * 64)).astype(np.float32)).to(dev).bfloat16()
do = torch.from_numpy(rng.normal(0, 1, (2, 700, 3 * 64)).astype(np.float32)).to(dev).bfloat16()
def run():
    x = qkv.clone().requires_grad_(True)
    out = la.long_attention_train(x, 3, 64)
    (out.float() * do.float()).sum().backward()
    return out.detach(), x.grad
a = run()
with reference_impl():
    p = run()
same = torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])
print("autograd identical", same, la.long_attention_bwd.launches, flush=True)
ok &= same
print("ALL OK" if ok else "MISMATCH", flush=True)
