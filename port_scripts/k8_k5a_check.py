"""K8 (both forms) and K5a in f32 on the card, against their plain versions and,
with --parent, against the parent commit's kernels.

- the ptxas register and spill report of csrc/attention_q_mma.cu (K3, kernel A
  and the bf16 K8 on the tensor cores) and csrc/attention_f32.cu (kernel A, the
  f32 K8 and K5a on the CUDA cores);
- the bf16 K8 (qvt_flash_attention_mma) against its plain version with
  chip_smoke's compare_tc (within 2^-7 (1 + |plain|), at most twice the plain
  version's rel L2 to the f64 math), two launches identical, from N 1 to
  4,000 (K and V resident and streamed), hd 8 to 128, masked keys;
- the f32 K8 (qvt_flash_attention_f32) and K5a (qvt_attention_fwd) identical
  to their plain versions, N 577 and 1,025 (K8) and 2,305 and 7,000 (K5a)
  among them;
- then (unless --quick) each at the main paths' shapes and past the earlier
  kernels' plans, timed by CUDA events around one call (median of 30), around
  10 back-to-back calls, and by device time under torch.profiler (20 calls),
  beside SDPA's forward by both clocks and the bound; with --parent DIR the
  parent's CUDA-core kernels (attention_q.cu's qvt_flash_attention,
  attention_long.cu's qvt_attention_long) built from that checkout and called
  directly (no wrapper), in turns (parent, change, change, parent), their f32
  bits compared with the change's; and the f32 kernel A (qvt_attention_fwd,
  attention_f32.cu) against the parent's at the f32 K1 shapes and K5a's, the
  same way.

    python3 port_scripts/k8_k5a_check.py [--quick] [--parent DIR]
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
from qat_vit_tpu_torch.ops import long_attention as la  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--quick", action="store_true", help="build, report and check; no timing")
ap.add_argument("--parent", help="a checkout of the parent commit to time against")
args = ap.parse_args()

nvcc = _build._nvcc()
for src in ("attention_q_mma.cu", "attention_f32.cu"):
    r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                        str(_build.CSRC / src), "-o", os.devnull], capture_output=True, text=True)
    keep = [ln for ln in (r.stdout + r.stderr).splitlines()
            if "error" in ln or "spill" in ln or "registers" in ln or "Compiling entry" in ln]
    print(src, "rc", r.returncode, "\n" + "\n".join(keep), flush=True)
    if r.returncode:
        sys.exit(1)

dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
card = cs.card_line()
print(card, flush=True)
BF16, F32 = torch.bfloat16, torch.float32
rng = np.random.default_rng(13)


def qkv_of(b, n, h, hd, dtype=F32):
    return torch.from_numpy(rng.normal(0, 1.0, (b, n, 3 * h * hd)).astype(np.float32)).to(
        dev).to(dtype)


# ---- correctness ----
K8_BF16 = [(2, 1, 2, 64, 1), (3, 5, 2, 64, 4), (4, 32, 2, 64, 17), (32, 197, 6, 64, 147),
           (2, 50, 4, 32, 41), (2, 130, 2, 128, 130), (2, 33, 3, 8, 33), (1, 130, 2, 72, 120),
           (8, 577, 6, 64, 570), (1, 1025, 4, 64, 1000), (1, 577, 2, 128, 570),
           (1, 4000, 2, 64, 4000)]
K8_F32 = [(32, 197, 6, 64, 197), (32, 197, 6, 64, 147), (2, 50, 4, 32, 41), (2, 130, 2, 128, 130),
          (8, 577, 6, 64, 577), (1, 1025, 4, 64, 1000), (1, 577, 2, 128, 570)]
K5A_F32 = [(2, 197, 6, 64, 197), (1, 520, 2, 72, 500), (2, 2305, 9, 64, 2305),
           (1, 7000, 2, 64, 6990)]
for b, n, h, hd, nv in K8_BF16:
    qkv = qkv_of(b, n, h, hd, BF16)
    got = fa.flash_attention_qkv(qkv, h, hd, n_valid=nv)
    name = f"K8 bf16 [{b}x{n}x{3 * h * hd}] {h} heads n_valid {nv}"
    worst, notes = cs.compare_tc(name, got, fa.flash_attention_qkv_plain(qkv, h, hd, n_valid=nv),
                                 la.long_attention_f64(qkv, h, hd, n_valid=nv)[0], 1)
    same = torch.equal(got, fa.flash_attention_qkv(qkv, h, hd, n_valid=nv))
    print(f"{name}: {notes[0]}; two launches identical {same}", flush=True)
    if not same:
        sys.exit(f"{name}: two launches differ")
for label, wrapper, plain, shapes in (
        ("K8 f32", fa.flash_attention_qkv, fa.flash_attention_qkv_plain, K8_F32),
        ("K5a f32", la.long_attention_qkv, la.long_attention_qkv_plain, K5A_F32)):
    for b, n, h, hd, nv in shapes:
        qkv = qkv_of(b, n, h, hd)
        got = wrapper(qkv, h, hd, n_valid=nv)
        same = torch.equal(got, plain(qkv, h, hd, n_valid=nv))
        again = torch.equal(got, wrapper(qkv, h, hd, n_valid=nv))
        rows = fa.attention_f32_rows(n, hd)
        print(f"{label} [{b}x{n}x{3 * h * hd}] {h} heads n_valid {nv} ({rows} rows per block): "
              f"identical to plain {same}, two launches identical {again}", flush=True)
        if not (same and again):
            sys.exit(f"{label} {(b, n, h, hd, nv)} differs")
if args.quick:
    print(f"done (--quick) on {card}", flush=True)
    sys.exit(0)

# ---- the parent's CUDA-core K8 and f32 K5a, for timing in turns ----
parent = None
if args.parent:
    csrc = os.path.join(args.parent, "qat_vit_tpu_torch", "csrc")
    tmp = tempfile.mkdtemp()
    objs = []
    for src in ("attention_q.cu", "attention_long.cu", "attention_f32.cu"):
        objs.append(os.path.join(tmp, src + ".o"))
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", csrc, "-c", os.path.join(csrc, src), "-o",
                        objs[-1]], check=True)
    lib = os.path.join(tmp, "parent.so")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib, *objs], check=True)
    parent = ctypes.CDLL(lib)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    parent.qvt_flash_attention.argtypes = [P, P] + [I] * 5 + [F, I, P]
    parent.qvt_attention_long.argtypes = [P, P] + [I] * 5 + [F, P]
    parent.qvt_attention_fwd.argtypes = [P] * 3 + [I] * 5 + [F, I, F, F, P]
    print("parent K8, f32 K5a and f32 kernel A built from", args.parent, flush=True)
stream = torch.cuda.current_stream().cuda_stream


def parent_k8(qkv, h, hd, nv, out):
    b, n, _ = qkv.shape
    err = parent.qvt_flash_attention(qkv.data_ptr(), out.data_ptr(), b, n, h, hd, nv,
                                     hd ** -0.5, int(qkv.dtype == F32), stream)
    assert err == 0, err


def parent_k5a(qkv, h, hd, nv, out):
    b, n, _ = qkv.shape
    err = parent.qvt_attention_long(qkv.data_ptr(), out.data_ptr(), b, n, h, hd, nv,
                                    float(np.float32(hd ** -0.5)), stream)
    assert err == 0, err


def parent_a(qkv, h, hd, nv, out):
    b, n, _ = qkv.shape
    err = parent.qvt_attention_fwd(qkv.data_ptr(), None, out.data_ptr(), b, n, h, hd, nv,
                                   float(np.float32(hd ** -0.5)), 0, 0.0, 0.0, stream)
    assert err == 0, err


# (label, wrapper, parent call, batch, tokens, heads, hd, n_valid, dtype); the
# parent takes K8 to 789 / 420 tokens (bf16 / f32) and K5a to 6,048 at hd 64
TIMED = [("K8", fa.flash_attention_qkv, parent_k8, 32, 197, 6, 64, 147, BF16),
         ("K8", fa.flash_attention_qkv, parent_k8, 32, 197, 6, 64, 197, F32),
         ("K8", fa.flash_attention_qkv, parent_k8, 32, 197, 6, 64, 147, F32),
         ("K5a", la.long_attention_qkv, parent_k5a, 2, 2305, 9, 64, 2305, F32),
         ("K8", fa.flash_attention_qkv, None, 8, 577, 6, 64, 577, BF16),
         ("K8", fa.flash_attention_qkv, None, 8, 577, 6, 64, 577, F32),
         ("K5a", la.long_attention_qkv, None, 1, 7000, 9, 64, 7000, F32),
         ("kernel A", fa.attention_fwd, parent_a, 8, 197, 6, 64, 197, F32),
         ("kernel A", fa.attention_fwd, parent_a, 256, 197, 6, 64, 197, F32),
         ("kernel A", fa.attention_fwd, parent_a, 2, 512, 6, 128, 512, F32),
         ("kernel A", fa.attention_fwd, parent_a, 1, 1248, 1, 128, 1248, F32),
         ("kernel A", fa.attention_fwd, parent_a, 2, 2305, 9, 64, 2305, F32),
         ("kernel A", fa.attention_fwd, parent_a, 1, 7000, 9, 64, 7000, F32)]
for label, wrapper, pcall, b, n, h, hd, nv, dt in TIMED:
    qkv = qkv_of(b, n, h, hd, dt)
    fns = {"change": lambda: wrapper(qkv, h, hd, n_valid=nv)}
    order = ["change"]
    if parent is not None and pcall is not None:
        out = torch.empty(b, n, h * hd, dtype=dt, device=dev)
        fns["parent"] = lambda: pcall(qkv, h, hd, nv, out)
        fns["parent"]()
        torch.cuda.synchronize()
        if dt == F32 and not torch.equal(out, fns["change"]()):
            sys.exit(f"{label} f32 {(b, n, h, hd, nv)}: the parent's bits differ")
        order = ["parent", "change", "change", "parent"]
    times = {}
    for who in order:
        fn = fns[who]
        t = times.setdefault(who, {"one": [], "b2b": [], "device": []})
        t["one"].append(cs.median_ms(fn))
        t["b2b"].append(cs.median_ms(fn, reps=10))
        t["device"].append(cs.device_ms(torch, fn))
    sdpa = cs.sdpa_forward(torch, qkv, h, hd)
    eb = 4 if dt == F32 else 2
    bound, by = cs.roofline(cs.attention_work(b, n, h, hd, eb, in_bytes=eb,
                                              op_type="f32" if dt == F32 else "bf16"))
    print(f"{label} {'f32' if dt == F32 else 'bf16'} [{b}x{n}x{3 * h * hd}] {h} heads n_valid "
          f"{nv}: " + "; ".join(
              f"{who} one call {' / '.join(f'{v:.4f}' for v in t['one'])} ms, 10 back to back "
              f"{' / '.join(f'{v:.4f}' for v in t['b2b'])}, device "
              f"{' / '.join(f'{v:.4f}' for v in t['device'])}" for who, t in times.items())
          + f"; SDPA one call {cs.median_ms(sdpa):.4f} device {cs.device_ms(torch, sdpa):.4f}; "
          f"bound {bound:.4f} ({by})", flush=True)
print(f"done on {card}", flush=True)
