"""K6a (qvt_attention_long_q_mma / _q8_mma: the quantizing attention of K6 on the
tensor cores) and K2c (qvt_int8_gemm_resid_ln: the pipelined RESID_LN_Q GEMM) on the
card: the ptxas register and spill report of both sources; K6a in both score forms
against its plain versions with chip_smoke's int8 bound, and K2c at every block height
against its plain version bit for bit; then (unless --quick) both timed beside SDPA /
torch._int_mm and their bounds at the main paths' shapes, K2c at each block height,
and, with --parent, the same calls through the parent commit's kernels
(attention_long.cu's qvt_attention_long_q / _q8, int8_gemm.cu's RESID_LN_Q epilogue)
built from that checkout, timed in turns: parent, change, change, parent.

    python3 port_scripts/k6_k2c_check.py [--quick] [--parent DIR]
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from qat_vit_tpu_torch import _build  # noqa: E402
from qat_vit_tpu_torch.ops import fused_serve as fs  # noqa: E402
from qat_vit_tpu_torch.ops import long_attention as la  # noqa: E402
from qat_vit_tpu_torch.ops.flash_attention import _q_scale  # noqa: E402
from qat_vit_tpu_torch.ops.quantized_matmul import f32  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--quick", action="store_true", help="build, report and check; no timing")
ap.add_argument("--parent", help="a checkout of the parent commit to time against")
args = ap.parse_args()

nvcc = _build._nvcc()
for src in ("attention_long_q_mma.cu", "int8_gemm.cu"):
    r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                        str(_build.CSRC / src), "-o", os.devnull], capture_output=True, text=True)
    lines = (r.stdout + r.stderr).splitlines()
    keep = [ln for ln in lines if "error" in ln or "spill" in ln or "registers" in ln
            or ("Compiling entry" in ln and ("long_attention_q" in ln or "resid_ln" in ln))]
    print(src, "rc", r.returncode, "\n" + "\n".join(keep), flush=True)
    if r.returncode:
        sys.exit(1)
print("built in", _build.load().build_seconds, "s", flush=True)
card = cs.card_line()
print(card, flush=True)
dev = torch.device("cuda")
bf16 = torch.bfloat16


def k6_inputs(b, n, h, hd, seed):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * h * hd)).astype(np.float32)).to(dev)
    qk8 = np.clip(np.round(rng.normal(3, 60, (b, n, 2 * h * hd))), -128, 127).astype(np.int8)
    return qkv.to(bf16), torch.from_numpy(qk8).to(dev)


OUT_Q = {"scale": torch.tensor(8.0 / 255), "zero_point": torch.tensor(128.0)}
OUT_Q8 = {"scale": torch.tensor(0.03), "zero_point": torch.tensor(131.0)}


def check_k6(b, n, h, hd, nv):
    qkv, qk8 = k6_inputs(b, n, h, hd, n + hd)
    for name, fn, plain, a, kw in (
            ("attention_long_q", la.long_attention_q, la.long_attention_qkv_plain, (qkv, h, hd),
             {"out_q": OUT_Q, "n_valid": nv}),
            ("attention_long_q8", la.long_attention_q8, la.long_attention_q8_plain,
             (qk8, qkv, h, hd), {"out_q": OUT_Q8, "n_valid": nv})):
        got = fn(*a, **kw)
        torch.cuda.synchronize()
        want = plain(*a, **kw)
        worst, exact = cs.compare_int8(name, got, want)
        same = torch.equal(got, fn(*a, **kw))
        print(f"check {name} [{b}x{n}x{3 * h * hd}] {h}x{hd} n_valid {nv}: max|diff| {worst:.0f} "
              f"exact {exact:.7f} two launches identical {same}", flush=True)
        if not same:
            sys.exit(1)


def k2c_inputs(m, k, n, res_dt, seed):
    rng = np.random.default_rng(seed)
    x = cs.rand_int8(torch, np, rng, dev, m, k)
    layer = fs.with_packed_weight(cs.rand_layer(torch, np, rng, dev, k, n))
    r = torch.from_numpy(rng.normal(0, 1.5, (m, n)).astype(np.float32)).to(dev).to(res_dt)
    return x, layer, r, cs.rand_ln(torch, np, rng, dev, n)


IN_Q = {"scale": torch.tensor(0.02), "zero_point": torch.tensor(121.0)}
LN_Q = {"scale": torch.tensor(8.0 / 255), "zero_point": torch.tensor(128.0)}
rows_rule = fs.resid_ln_rows


def forced_rows(bm):
    fs.resid_ln_rows = (lambda m, n: bm) if bm else rows_rule


def k2c_call(x, layer, r, ln, out_dt):
    return fs.int8_dense_resid_ln_q(x, layer, IN_Q, r, ln, LN_Q, out_dtype=out_dt, eps=1e-5)


# (label, M, K, N, residual dtype, output dtype): the four main-path shapes at the
# batches chip_smoke times them, and the batches the serving paths run
K2C = [("ViT-S proj b32", 6304, 384, 384, bf16, torch.float32),
       ("ViT-S fc2 b32", 6304, 1536, 384, torch.float32, bf16),
       ("OWLv2 proj b2", 4610, 576, 576, bf16, torch.float32),
       ("OWLv2 fc2 b2", 4610, 3072, 576, torch.float32, bf16),
       ("ViT-S fc2 b256", 50_432, 1536, 384, torch.float32, bf16),
       ("OWLv2 fc2 b8", 18_440, 3072, 576, torch.float32, bf16)]


def check_k2c():
    for label, m, k, n, rdt, odt in K2C + [("N 1756", 300, 384, 1756, bf16, torch.float32)]:
        x, layer, r, ln = k2c_inputs(m, k, n, rdt, m + k)
        want = fs.int8_dense_resid_ln_q_plain(x, layer, IN_Q, r, ln, LN_Q, out_dtype=odt, eps=1e-5)
        for bm in fs.RESID_LN_BLOCK_ROWS:
            if fs.resid_ln_smem_bytes(bm, n) > la.SMEM_LIMIT:
                continue
            forced_rows(bm)
            got = k2c_call(x, layer, r, ln, odt)
            forced_rows(None)
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"check K2c {label} [{m}x{k}]@[{k}x{n}] rows {bm}: identical {same}", flush=True)
            if not same:
                sys.exit(1)


for shape in ((2, 2305, 9, 64, 2305), (1, 10_001, 2, 64, 9_999), (1, 300, 2, 72, 290),
              (1, 200, 2, 128, 200), (1, 77, 3, 40, 77)):
    check_k6(*shape)
check_k2c()
print("checks ok", flush=True)
if args.quick:
    sys.exit(0)


# ---- the parent commit's kernels, for timing in turns ----
parent = None
if args.parent:
    csrc = os.path.join(args.parent, "qat_vit_tpu_torch", "csrc")
    tmp = tempfile.mkdtemp()
    objs = []
    procs = []
    for src in ("attention_long.cu", "int8_gemm.cu"):
        obj = os.path.join(tmp, src + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", csrc, "-c",
                                       os.path.join(csrc, src), "-o", obj]))
    if any(p.wait() for p in procs):
        sys.exit("parent build failed")
    lib = os.path.join(tmp, "parent.so")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib, *objs], check=True)
    parent = ctypes.CDLL(lib)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    parent.qvt_attention_long_q.argtypes = [P, P] + [I] * 5 + [F] * 4 + [P]
    parent.qvt_attention_long_q8.argtypes = [P] * 3 + [I] * 5 + [F, I, F, F, F, P]
    parent.qvt_int8_gemm.argtypes = [P] * 10 + [I] * 8 + [F, F, I, F, F, F, F, I, P]
    print("parent kernels built from", args.parent, flush=True)


def stream():
    return torch.cuda.current_stream().cuda_stream


def parent_k6(qkv, qk8, h, hd, out):
    b, n, _ = qkv.shape
    if qk8 is None:
        err = parent.qvt_attention_long_q(qkv.data_ptr(), out.data_ptr(), b, n, h, hd, n,
                                          float(_q_scale(hd, bf16)), fs.inv_scale(OUT_Q["scale"]),
                                          f32(OUT_Q["zero_point"]), 255.0, stream())
    else:
        err = parent.qvt_attention_long_q8(
            qk8.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, n, h, hd, n,
            la.q8_score_scale(OUT_Q8["scale"], hd), int(f32(OUT_Q8["zero_point"])) - 128,
            fs.inv_scale(OUT_Q8["scale"]), f32(OUT_Q8["zero_point"]), 255.0, stream())
    assert err == 0, err


def parent_k2c(x, layer, r, ln, odt, y, q):
    m, k = x.shape
    n = layer["w_int8"].shape[1]
    err = parent.qvt_int8_gemm(
        x.data_ptr(), layer["w_int8"].data_ptr(), layer["w_colsum"].data_ptr(),
        layer["bias"].data_ptr(), None, r.data_ptr(), ln["scale"].data_ptr(),
        ln["bias"].data_ptr(), y.data_ptr(), q.data_ptr(), m, n, k, 2, int(odt == bf16),
        int(r.dtype == bf16), 0, 0, f32(layer["w_scale"]), f32(IN_Q["scale"]),
        int(f32(IN_Q["zero_point"])) - 128, fs.inv_scale(LN_Q["scale"]), f32(LN_Q["zero_point"]),
        255.0, float(np.float32(1e-5)), n, stream())
    assert err == 0, err


def turns(label, fns, work, library):
    """Time ``fns`` ({name: fn}) in turns (parent, change, change, parent
    where a parent is given): CUDA events around one call (the host's
    launch cost included where the card waits for it), around 10
    back-to-back calls as chip_smoke times a kernel, and the device time
    under the profiler; print each with the bound and the library call."""
    order = list(fns)
    if "parent" in fns:
        order = ["parent"] + [k for k in fns if k != "parent"] * 2 + ["parent"]
    one, times, dev_times = {}, {}, {}
    for k in order:
        one.setdefault(k, []).append(cs.median_ms(fns[k]))
        times.setdefault(k, []).append(cs.median_ms(fns[k], reps=cs.KERNEL_REPS))
        dev_times.setdefault(k, []).append(cs.device_ms(torch, fns[k]))
    lib = cs.median_ms(library, reps=cs.KERNEL_REPS) if library is not None else None
    lib_dev = cs.device_ms(torch, library) if library is not None else None
    bound, by = cs.roofline(*(work if isinstance(work, list) else [work]))
    lib_s = f"{lib:.4f} (device {lib_dev:.4f})" if lib is not None else "none"
    print(f"time {label}: " + ", ".join(
        f"{k} {' / '.join(f'{v:.4f}' for v in times[k])} ms (one call "
        f"{' / '.join(f'{v:.4f}' for v in one[k])}, device "
        f"{' / '.join(f'{v:.4f}' for v in dev_times[k])})" for k in times)
          + f"; library {lib_s} ms; bound {bound:.4f} ms ({by}) on {card}", flush=True)


for b in (2, 8):
    n, h, hd = 2305, 9, 64
    qkv, qk8 = k6_inputs(b, n, h, hd, b)
    out = torch.empty(b, n, h * hd, dtype=torch.int8, device=dev)
    fns = {"change": lambda: la.long_attention_q(qkv, h, hd, out_q=OUT_Q)}
    if parent is not None:
        fns["parent"] = lambda: parent_k6(qkv, None, h, hd, out)
    turns(f"K6a bf16 [{b}x{n}x{3 * h * hd}]", fns, cs.attention_work(b, n, h, hd, 1),
          cs.sdpa_forward(torch, qkv, h, hd))
    fns = {"change": lambda: la.long_attention_q8(qk8, qkv, h, hd, out_q=OUT_Q8)}
    if parent is not None:
        fns["parent"] = lambda: parent_k6(qkv, qk8, h, hd, out)
    q8_work = [{"ops": 2 * b * h * n * n * hd, "type": "int8",
                "bytes": b * n * 2 * h * hd + 2 * b * n * h * hd + b * n * h * hd},
               {"ops": 2 * b * h * n * n * hd, "type": "bf16", "bytes": 0}]
    turns(f"K6a i8 [{b}x{n}x{3 * h * hd}]", fns, q8_work, None)
    del qkv, qk8, out

for label, m, k, n, rdt, odt in K2C:
    x, layer, r, ln = k2c_inputs(m, k, n, rdt, m + k)
    fns = {}
    for bm in fs.RESID_LN_BLOCK_ROWS:
        if fs.resid_ln_smem_bytes(bm, n) <= la.SMEM_LIMIT:
            fns[f"rows {bm}"] = (lambda bm=bm: (forced_rows(bm), k2c_call(x, layer, r, ln, odt),
                                                forced_rows(None)))
    if parent is not None:
        y = torch.empty(m, n, dtype=odt, device=dev)
        q = torch.empty(m, n, dtype=torch.int8, device=dev)
        fns["parent"] = lambda: parent_k2c(x, layer, r, ln, odt, y, q)
    extra = (2 if rdt == bf16 else 4) * m * n + 8 * n
    turns(f"K2c {label} [{m}x{k}]@[{k}x{n}] (rule: rows {rows_rule(m, n)})", fns,
          cs.gemm_work(m, k, n, (2 if odt == bf16 else 4) + 1, extra),
          cs.int_mm(torch, x, layer))
print("done", flush=True)
