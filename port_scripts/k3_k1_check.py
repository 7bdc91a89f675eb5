"""K3 and the bf16 kernel A (qvt_attention_q_mma / qvt_attention_fwd_mma: the
short-sequence attention on the tensor cores, csrc/attention_q_mma.cu) on the card:
the ptxas register and spill report of every form; K3 against its plain version with
chip_smoke's int8 bound and kernel A (in_fq off and on) with chip_smoke's compare_tc
(2^-7 (1 + |plain|), twice the plain version's distance from the f64 math), two
launches identical, at ViT-S batch 32 and 256, odd N, n_valid < N, hd 8 to 128 and the
gate's edges (K and V resident, and streamed where they do not fit); then (unless
--quick) each form timed beside SDPA and its bound at [32, 197, 1152] and
[256, 197, 1152]: CUDA events around one call, around 10 back-to-back calls, and
device time under torch.profiler; with --parent, the same calls through the parent
commit's CUDA-core kernels (attention_q.cu's qvt_attention_q / qvt_attention_fwd)
built from that checkout, timed in turns: parent, change, change, parent.

    python3 port_scripts/k3_k1_check.py [--quick] [--parent DIR]
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
from qat_vit_tpu_torch.ops import flash_attention as fa  # noqa: E402
from qat_vit_tpu_torch.ops import fused_serve as fs  # noqa: E402
from qat_vit_tpu_torch.ops import long_attention as la  # noqa: E402
from qat_vit_tpu_torch.ops.flash_attention import _q_scale  # noqa: E402
from qat_vit_tpu_torch.ops.quantized_matmul import f32  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--quick", action="store_true", help="build, report and check; no timing")
ap.add_argument("--parent", help="a checkout of the parent commit to time against")
args = ap.parse_args()

nvcc = _build._nvcc()
r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                    str(_build.CSRC / "attention_q_mma.cu"), "-o", os.devnull],
                   capture_output=True, text=True)
keep = [ln for ln in (r.stdout + r.stderr).splitlines()
        if "error" in ln or "spill" in ln or "registers" in ln or "Compiling entry" in ln]
print("attention_q_mma.cu rc", r.returncode, "\n" + "\n".join(keep), flush=True)
if r.returncode:
    sys.exit(1)
print("built in", _build.load().build_seconds, "s", flush=True)
card = cs.card_line()
print(card, flush=True)
dev = torch.device("cuda")
bf16 = torch.bfloat16
OUT_Q = {"scale": torch.tensor(8.0 / 255), "zero_point": torch.tensor(128.0)}
# chip_smoke's qkv fake-quant grid: its ends clip ~3% of N(0, 1)
FQ = {"qs": torch.tensor([4.2 / 255, 127.0], dtype=torch.float32, device=dev), "in_fq": (0, 255)}


def qkv_case(b, n, h, hd, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(0, 1, (b, n, 3 * h * hd)).astype(np.float32)).to(dev).to(bf16)


def check(b, n, h, hd, nv):
    qkv = qkv_case(b, n, h, hd, n + 7 * hd + b)
    got = fa.fused_attention_qkv(qkv, h, hd, out_q=OUT_Q, n_valid=nv)
    torch.cuda.synchronize()
    want = fa.fused_attention_qkv_plain(qkv, h, hd, out_q=OUT_Q, n_valid=nv)
    worst, exact = cs.compare_int8("K3", got, want)
    same = torch.equal(got, fa.fused_attention_qkv(qkv, h, hd, out_q=OUT_Q, n_valid=nv))
    line = (f"check [{b}x{n}x{3 * h * hd}] {h}x{hd} n_valid {nv}: K3 max|diff| {worst:.0f} "
            f"exact {exact:.7f} same {same}")
    for kw in ({}, FQ):
        got = fa.attention_fwd(qkv, h, hd, n_valid=nv, **kw)
        torch.cuda.synchronize()
        again = fa.attention_fwd(qkv, h, hd, n_valid=nv, **kw)
        _, notes = cs.compare_tc("kernel A", got, fa.attention_fwd_plain(qkv, h, hd, n_valid=nv, **kw),
                                 la.long_attention_f64(qkv, h, hd, n_valid=nv, **kw)[0], 1)
        line += f"; A{' in_fq' if kw else ''} {notes[0]} same {torch.equal(got, again)}"
        same = same and torch.equal(got, again)
    print(line, flush=True)
    if not same:
        sys.exit("two launches on the same inputs differ")


# ViT-S at both batches; odd N and masked keys; hd 8 to 128; the gate's edges:
# N 789 at hd 64 and 416 at hd 128 (resident), 1,411 at hd 32, 710 at hd 72 and
# 3,414 at hd 8 (streamed)
for shape in ((32, 197, 6, 64, 197), (256, 197, 6, 64, 197), (2, 1, 2, 64, 1), (3, 5, 2, 64, 4),
              (2, 17, 2, 64, 17), (2, 150, 4, 64, 131), (2, 197, 12, 64, 150), (2, 33, 3, 8, 33),
              (2, 97, 2, 32, 90), (2, 130, 2, 72, 130), (2, 77, 2, 128, 77),
              (1, 789, 2, 64, 789), (1, 416, 2, 128, 400), (1, 1411, 1, 32, 1411),
              (1, 710, 1, 72, 710), (1, 3414, 1, 8, 3000)):
    assert fa.attention_fwd_shapes_ok(shape[1], shape[3]), shape
    check(*shape)
print("checks ok", flush=True)
if args.quick:
    sys.exit(0)

# ---- the parent commit's kernels, for timing in turns ----
parent = None
if args.parent:
    csrc = os.path.join(args.parent, "qat_vit_tpu_torch", "csrc")
    tmp = tempfile.mkdtemp()
    obj, lib = os.path.join(tmp, "attention_q.o"), os.path.join(tmp, "parent.so")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", csrc, "-c", os.path.join(csrc, "attention_q.cu"),
                    "-o", obj], check=True)
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib, obj], check=True)
    parent = ctypes.CDLL(lib)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    parent.qvt_attention_q.argtypes = [P, P] + [I] * 5 + [F] * 4 + [P]
    parent.qvt_attention_fwd.argtypes = [P] * 3 + [I] * 5 + [F, I, F, F, I, P]
    print("parent kernels built from", args.parent, flush=True)


def stream():
    return torch.cuda.current_stream().cuda_stream


def parent_k3(qkv, h, hd, out):
    b, n, _ = qkv.shape
    err = parent.qvt_attention_q(qkv.data_ptr(), out.data_ptr(), b, n, h, hd, n,
                                 float(_q_scale(hd, bf16)), fs.inv_scale(OUT_Q["scale"]),
                                 f32(OUT_Q["zero_point"]), 255.0, stream())
    assert err == 0, err


def parent_a(qkv, h, hd, out, fq):
    b, n, _ = qkv.shape
    err = parent.qvt_attention_fwd(qkv.data_ptr(), FQ["qs"].data_ptr() if fq else None,
                                   out.data_ptr(), b, n, h, hd, n, float(_q_scale(hd, bf16)),
                                   int(fq), 0.0, 255.0, 0, stream())
    assert err == 0, err


def turns(label, fns, work, library):
    """Time ``fns`` ({name: fn}) in turns (parent, change, change, parent
    where a parent is given): CUDA events around one call (chip_smoke's
    ``ms``, the host's launch cost included where the card waits for it),
    the mean of 10 back-to-back calls, and the device time under the
    profiler; print each with the bound and the library call (SDPA)."""
    order = list(fns)
    if "parent" in fns:
        order = ["parent"] + [k for k in fns if k != "parent"] * 2 + ["parent"]
    one, b2b, dev_t = {}, {}, {}
    for k in order:
        one.setdefault(k, []).append(cs.median_ms(fns[k]))
        b2b.setdefault(k, []).append(cs.median_ms(fns[k], reps=cs.KERNEL_REPS))
        dev_t.setdefault(k, []).append(cs.device_ms(torch, fns[k]))
    lib, lib_dev = cs.median_ms(library), cs.device_ms(torch, library)
    bound, by = cs.roofline(work)
    print(f"time {label}: " + ", ".join(
        f"{k} one call {' / '.join(f'{v:.4f}' for v in one[k])} ms (10 back to back "
        f"{' / '.join(f'{v:.4f}' for v in b2b[k])}, device "
        f"{' / '.join(f'{v:.4f}' for v in dev_t[k])})" for k in one)
          + f"; SDPA one call {lib:.4f} (device {lib_dev:.4f}) ms; bound {bound:.4f} ms ({by})"
          f" on {card}", flush=True)


for b in (32, 256):
    n, h, hd = 197, 6, 64
    qkv = qkv_case(b, n, h, hd, b)
    out8 = torch.empty(b, n, h * hd, dtype=torch.int8, device=dev)
    out16 = torch.empty(b, n, h * hd, dtype=bf16, device=dev)
    sdpa = cs.sdpa_forward(torch, qkv, h, hd)
    fns = {"change": lambda: fa.fused_attention_qkv(qkv, h, hd, out_q=OUT_Q)}
    if parent is not None:
        fns["parent"] = lambda: parent_k3(qkv, h, hd, out8)
    turns(f"K3 [{b}x{n}x{3 * h * hd}]", fns, cs.attention_work(b, n, h, hd, 1), sdpa)
    for fq in (False, True):
        kw = FQ if fq else {}
        fns = {"change": lambda kw=kw: fa.attention_fwd(qkv, h, hd, **kw)}
        if parent is not None:
            fns["parent"] = lambda fq=fq: parent_a(qkv, h, hd, out16, fq)
        turns(f"kernel A{' in_fq' if fq else ''} [{b}x{n}x{3 * h * hd}]", fns,
              cs.attention_work(b, n, h, hd), sdpa)
    del qkv, out8, out16
print("done", flush=True)
