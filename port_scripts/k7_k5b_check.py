"""K7 (the fused quantize GEMM) and K5b in f32 on the card, against their plain
versions and, with --parent, against the parent commit's kernels.

- the ptxas register and spill report of csrc/int8_gemm_wgmma.cu and
  csrc/attention_f32.cu;
- K7 (pallas_gemm.fused_quantize_matmul) identical to its plain version at
  the exact path's five batch-32 shapes (patch [6272, 768] @ [768, 384], qkv
  [6304, 384] @ [384, 1152], proj @ [384, 384], fc1 @ [384, 1536], fc2
  [6304, 1536] @ [1536, 384]), each with f32 and bf16 x, per-tensor and
  per-channel weight scales, f32 out (and bf16 out at qkv), and at K 96 and
  480 (K = 32 mod 64); two launches identical;
- K5b in f32 (long_attention.long_attention_bwd) identical to its plain
  version at [2, 2305, 1728] (OWLv2-pruned, 9 heads of 64) and [1, 4096,
  1728] with n_valid 4,090; two launches identical;
- then (unless --quick) each timed by CUDA events around one call (median of
  30), around 10 back-to-back calls, and by device time under torch.profiler
  (20 calls), beside the library call (K7: torch._int_mm on the
  pre-quantized int8 x; K5b: SDPA's f32 backward) by both clocks and the
  bound; with --parent DIR the parent's kernels (int8_gemm.cu's
  qvt_quantize_gemm, attention_long_bwd.cu's qvt_attention_long_bwd) built
  from that checkout and called directly (no wrapper, so the parent's
  one-call and back-to-back times hold no wrapper host time, the change's
  do; port_scripts/k7_host_turns.py compares the two wrappers), in turns
  (parent, change, change, parent), their bits compared with the change's; and, to
  show that they did not move, the kernels that share the changed sources:
  the f32 kernel B (rows and keys passes) at [256, 197, 1152] and [2, 512,
  2304], the f32 kernel A (K5a's form) at [2, 2305, 1728] and the bf16 K5b
  (attention_long_bwd_mma.cu) at [16, 2305, 1728], each entry point of both
  builds called directly on the same buffers, device time in turns, bits
  compared.

Run it from the root of a checkout (it times that checkout's wrappers):

    python3 port_scripts/k7_k5b_check.py [--quick] [--parent DIR]
"""
import argparse
import ctypes
import inspect
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
from qat_vit_tpu_torch.ops import pallas_gemm as pg  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--quick", action="store_true", help="build, report and check; no timing")
ap.add_argument("--parent", help="a checkout of the parent commit to time against")
args = ap.parse_args()

nvcc = _build._nvcc()
for src in ("int8_gemm_wgmma.cu", "attention_f32.cu"):
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
rng = np.random.default_rng(14)
IN_Q = {"scale": torch.tensor(4.0 / 255), "zero_point": torch.tensor(100.0)}
# does this checkout's K7 take the packed weight (w_t=)?
TAKES_WT = "w_t" in inspect.signature(pg.fused_quantize_matmul).parameters

# (label, M, K, N): the exact path's GEMMs at batch 32 (197 tokens; the patch
# embedding over 196 patches)
K7_SHAPES = [("patch", 32 * 196, 768, 384), ("qkv", 32 * 197, 384, 1152),
             ("proj", 32 * 197, 384, 384), ("fc1", 32 * 197, 384, 1536),
             ("fc2", 32 * 197, 1536, 384)]
K7_TAIL = [("K 96", 8, 96, 128), ("K 480", 32 * 197, 480, 384), ("K 96 ragged", 394, 96, 384)]
K5B_SHAPES = [(2, 2305, 9, 64, 2305), (1, 4096, 9, 64, 4090)]


def k7_case(m, k, n, x_dt, per_channel, out_dt=F32):
    x = torch.from_numpy(rng.normal(0, 1.5, (m, k)).astype(np.float32)).to(dev).to(x_dt)
    layer = cs.rand_layer(torch, np, rng, dev, k, n, per_channel)
    kw = {"x_scale": IN_Q["scale"], "x_zero_point": IN_Q["zero_point"],
          "w_scale": layer["w_scale"], "w_colsum": layer["w_colsum"], "bias": layer["bias"],
          "out_dtype": out_dt}
    wkw = {"w_t": layer["w_int8_t"]} if TAKES_WT else {}
    return x, layer, kw, wkw


def k7_label(name, m, k, n, x_dt, per_channel, out_dt=F32):
    return (f"K7 {name} [{m}x{k}]@[{k}x{n}] {'f32' if x_dt == F32 else 'bf16'} in, "
            f"{'per-channel' if per_channel else 'per-tensor'}, "
            f"{'f32' if out_dt == F32 else 'bf16'} out")


# ---- correctness ----
for name, m, k, n in K7_SHAPES + K7_TAIL:
    forms = [(F32, False, F32), (F32, True, F32), (BF16, False, F32), (BF16, True, F32)]
    if name == "qkv":
        forms += [(F32, True, BF16), (BF16, False, BF16)]
    for x_dt, pc, out_dt in forms:
        x, layer, kw, wkw = k7_case(m, k, n, x_dt, pc, out_dt)
        got = pg.fused_quantize_matmul(x, layer["w_int8"], **kw, **wkw)
        want = pg.fused_quantize_matmul_plain(x, layer["w_int8"], **kw)
        same = torch.equal(got, want)
        again = torch.equal(got, pg.fused_quantize_matmul(x, layer["w_int8"], **kw, **wkw))
        label = k7_label(name, m, k, n, x_dt, pc, out_dt)
        print(f"{label}: identical to plain {same}, two launches identical {again}", flush=True)
        if not (same and again):
            diff = (got.float() - want.float()).abs()
            sys.exit(f"{label} differs: max |diff| {float(diff.max()):.3e}, "
                     f"{int((diff > 0).sum())} elements")


def qkv_of(b, n, h, hd):
    return torch.from_numpy(rng.normal(0, 1.0, (b, n, 3 * h * hd)).astype(np.float32)).to(dev)


for b, n, h, hd, nv in K5B_SHAPES:
    qkv, do = qkv_of(b, n, h, hd), torch.from_numpy(
        rng.normal(0, 1.0, (b, n, h * hd)).astype(np.float32)).to(dev)
    got = la.long_attention_bwd(qkv, do, h, hd, n_valid=nv)
    same = torch.equal(got, la.long_attention_bwd_plain(qkv, do, h, hd, n_valid=nv))
    again = torch.equal(got, la.long_attention_bwd(qkv, do, h, hd, n_valid=nv))
    print(f"K5b f32 [{b}x{n}x{3 * h * hd}] {h} heads n_valid {nv}: identical to plain {same}, "
          f"two launches identical {again}", flush=True)
    if not (same and again):
        sys.exit(f"K5b f32 {(b, n, h, hd, nv)} differs")
if args.quick:
    print(f"done (--quick) on {card}", flush=True)
    sys.exit(0)

# ---- the parent's K7 and f32 K5b, for timing in turns ----
parent = None
if args.parent:
    csrc = os.path.join(args.parent, "qat_vit_tpu_torch", "csrc")
    tmp = tempfile.mkdtemp()
    objs = []
    for src in ("int8_gemm.cu", "attention_long_bwd.cu", "attention_f32.cu",
                "attention_long_bwd_mma.cu"):
        objs.append(os.path.join(tmp, src + ".o"))
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", csrc, "-c", os.path.join(csrc, src), "-o",
                        objs[-1]], check=True)
    lib = os.path.join(tmp, "parent.so")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib, *objs], check=True)
    parent = ctypes.CDLL(lib)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    parent.qvt_quantize_gemm.argtypes = [P] * 6 + [I] * 6 + [F, F, I, F, F, F, P]
    parent.qvt_attention_long_bwd.argtypes = [P] * 4 + [I] * 5 + [F, F, P]
    for entry in ("qvt_attention_fwd", "qvt_attention_bwd_rows", "qvt_attention_bwd_keys",
                  "qvt_attention_long_bwd_mma"):
        getattr(parent, entry).argtypes = _build._SIGNATURES[entry]
    print("parent K7 and f32 K5b built from", args.parent, flush=True)
stream = torch.cuda.current_stream().cuda_stream


def parent_k7(x, layer, kw, y):
    m, k = x.shape
    n = layer["w_int8"].shape[1]
    pc = layer["w_scale"].ndim > 0
    err = parent.qvt_quantize_gemm(
        x.data_ptr(), layer["w_int8"].data_ptr(), layer["w_colsum"].data_ptr(),
        layer["bias"].data_ptr(), layer["w_scale"].data_ptr() if pc else None, y.data_ptr(),
        m, n, k, int(x.dtype == BF16), int(y.dtype == BF16), int(pc),
        0.0 if pc else float(np.float32(layer["w_scale"].item())), pg.f32(kw["x_scale"]),
        int(pg.f32(kw["x_zero_point"])) - 128, fs.inv_scale(kw["x_scale"]),
        pg.f32(kw["x_zero_point"]), 255.0, stream)
    assert err == 0, err


def parent_k5b(qkv, do, h, hd, nv, dqkv, stats):
    b, n, _ = qkv.shape
    s = float(np.float32(hd ** -0.5))
    err = parent.qvt_attention_long_bwd(qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
                                        stats.data_ptr(), b, n, h, hd, nv, s, s, stream)
    assert err == 0, err


def in_turns(fns):
    order = ["parent", "change", "change", "parent"] if "parent" in fns else ["change"]
    times = {}
    for who in order:
        fn = fns[who]
        t = times.setdefault(who, {"one": [], "b2b": [], "device": []})
        t["one"].append(cs.median_ms(fn))
        t["b2b"].append(cs.median_ms(fn, reps=10))
        t["device"].append(cs.device_ms(torch, fn))
    return "; ".join(
        f"{who} one call {' / '.join(f'{v:.4f}' for v in t['one'])} ms, 10 back to back "
        f"{' / '.join(f'{v:.4f}' for v in t['b2b'])}, device "
        f"{' / '.join(f'{v:.4f}' for v in t['device'])}" for who, t in times.items())


for name, m, k, n in K7_SHAPES:
    for x_dt, pc in ((F32, False), (F32, True), (BF16, False), (BF16, True)):
        x, layer, kw, wkw = k7_case(m, k, n, x_dt, pc)
        fns = {"change": lambda: pg.fused_quantize_matmul(x, layer["w_int8"], **kw, **wkw)}
        if parent is not None:
            y = torch.empty(m, n, device=dev)
            fns["parent"] = lambda: parent_k7(x, layer, kw, y)
            fns["parent"]()
            torch.cuda.synchronize()
            if not torch.equal(y, fns["change"]()):
                sys.exit(f"K7 {name}: the parent's bits differ")
        x_q = fs.quantize_mul(x.float(), fs.inv_scale(IN_Q["scale"]), 100.0, 255.0)
        lib = cs.int_mm(torch, x_q, layer)
        in_bytes = 4 if x_dt == F32 else 2
        bound, by = cs.roofline(cs.gemm_work(m, k, n, 4, (in_bytes - 1) * m * k))
        print(f"{k7_label(name, m, k, n, x_dt, pc)}: {in_turns(fns)}; _int_mm one call "
              f"{cs.median_ms(lib):.4f} device {cs.device_ms(torch, lib):.4f}; bound "
              f"{bound:.4f} ({by})", flush=True)

for b, n, h, hd, nv in K5B_SHAPES:
    qkv, do = qkv_of(b, n, h, hd), torch.from_numpy(
        rng.normal(0, 1.0, (b, n, h * hd)).astype(np.float32)).to(dev)
    fns = {"change": lambda: la.long_attention_bwd(qkv, do, h, hd, n_valid=nv)}
    if parent is not None:
        dqkv = torch.empty_like(qkv)
        stats = torch.empty(b, h, n, 4, dtype=torch.float64, device=dev)
        fns["parent"] = lambda: parent_k5b(qkv, do, h, hd, nv, dqkv, stats)
        fns["parent"]()
        torch.cuda.synchronize()
        if not torch.equal(dqkv, fns["change"]()):
            sys.exit(f"K5b f32 {(b, n)}: the parent's bits differ")
    sdpa = cs.sdpa_backward(torch, qkv, do, h, hd)
    bound, by = cs.roofline(cs.attention_work(b, n, h, hd, backward=True, in_bytes=4,
                                              op_type="f32"))
    print(f"K5b f32 [{b}x{n}x{3 * h * hd}] {h} heads n_valid {nv}: {in_turns(fns)}; SDPA "
          f"backward one call {cs.median_ms(sdpa):.4f} device {cs.device_ms(torch, sdpa):.4f}; "
          f"bound {bound:.4f} ({by})", flush=True)

# ---- the kernels sharing the changed sources, entry points called directly ----
if parent is not None:
    change = _build.load()._lib
    for b, n, h, hd in ((256, 197, 6, 64), (2, 512, 6, 128)):
        qkv, do = qkv_of(b, n, h, hd), torch.from_numpy(
            rng.normal(0, 1.0, (b, n, h * hd)).astype(np.float32)).to(dev)
        s = float(np.float32(hd ** -0.5))
        outs = {}
        fns = {}
        for who, lib in (("parent", parent), ("change", change)):
            st = torch.empty(3, b, h, n, dtype=torch.float64, device=dev)
            dq = torch.empty_like(qkv)
            outs[who] = dq

            def fn(lib=lib, st=st, dq=dq):
                for entry in ("qvt_attention_bwd_rows", "qvt_attention_bwd_keys"):
                    assert getattr(lib, entry)(qkv.data_ptr(), do.data_ptr(), None, st.data_ptr(),
                                               dq.data_ptr(), b, n, h, hd, n, s, 0, 0.0, 0.0,
                                               stream) == 0
            fns[who] = fn
            fn()
        torch.cuda.synchronize()
        print(f"kernel B f32 [{b}x{n}x{3 * h * hd}] {h} heads: bits identical to the parent's "
              f"{torch.equal(outs['parent'], outs['change'])}; {in_turns(fns)}", flush=True)
    b, n, h, hd = 2, 2305, 9, 64
    qkv = qkv_of(b, n, h, hd)
    s = float(np.float32(hd ** -0.5))
    outs, fns = {}, {}
    for who, lib in (("parent", parent), ("change", change)):
        out = torch.empty(b, n, h * hd, device=dev)
        outs[who] = out
        fns[who] = lambda lib=lib, out=out: lib.qvt_attention_fwd(
            qkv.data_ptr(), None, out.data_ptr(), b, n, h, hd, n, s, 0, 0.0, 0.0, stream)
        fns[who]()
    torch.cuda.synchronize()
    print(f"kernel A f32 (K5a) [{b}x{n}x{3 * h * hd}] {h} heads: bits identical to the parent's "
          f"{torch.equal(outs['parent'], outs['change'])}; {in_turns(fns)}", flush=True)
    b = 16
    qkv = qkv_of(b, n, h, hd).to(BF16)
    do = torch.from_numpy(rng.normal(0, 1.0, (b, n, h * hd)).astype(np.float32)).to(dev).to(BF16)
    out, lse = la._attention_launch(qkv, h, hd, n, want_lse=True)
    qs = float(torch.tensor(hd ** -0.5, dtype=BF16))
    outs, fns = {}, {}
    for who, lib in (("parent", parent), ("change", change)):
        dsum = torch.empty(b, h, n, device=dev)
        qsc = torch.empty(b, n, h * hd, dtype=BF16, device=dev)
        dq = torch.empty_like(qkv)
        outs[who] = dq
        fns[who] = lambda lib=lib, dsum=dsum, qsc=qsc, dq=dq: lib.qvt_attention_long_bwd_mma(
            qkv.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            qsc.data_ptr(), dq.data_ptr(), b, n, h, hd, n, qs, s, stream)
        fns[who]()
    torch.cuda.synchronize()
    print(f"K5b bf16 [{b}x{n}x{3 * h * hd}] {h} heads: bits identical to the parent's "
          f"{torch.equal(outs['parent'], outs['change'])}; {in_turns(fns)}", flush=True)
print(f"done on {card}", flush=True)
