"""Kernels A and B (K1) and the K1 gate's full N range on the card.

- the ptxas register and spill report of csrc/attention_bwd_mma.cu (the bf16
  kernel B on the tensor cores) and csrc/attention_f32.cu (the f32 kernels A
  and B on the CUDA cores);
- the bf16 kernel B (in_fq off and on) against its plain version with
  chip_smoke's compare_tc (dq, dk, dv within rel L2 1e-2, at most twice the
  plain version's rel L2 to the f64 math), two launches identical, the STE
  zero set identical, at ViT-S batch 32 and 256, odd N, n_valid < N, hd 8 to
  128 and N past the old shared-memory plan (up to 512 at 6 heads of 64 and
  of 128, 1,248 at one head of 128: the most JAX's K1 gate admits);
- the bf16 kernel A at N 512 (6 heads of 64 and of 128, both forms) by
  compare_tc, and the f32 kernels A and B there, at ViT-S and at N 1,248
  identical to their plain versions, with their rows per block;
- then (unless --quick) the bf16 kernel B timed at [32, 197, 1152] and
  [256, 197, 1152] in both forms beside SDPA's autograd backward and its
  bound: CUDA events around one call, around 10 back-to-back calls, and
  device time under torch.profiler (each kernel of the two passes too);
- and the f32 kernels A and B at chip_smoke's phase-8 shapes, in_fq off and
  on: with --parent DIR, the parent commit's f32 kernels (attention_q.cu's
  qvt_attention_fwd, attention_bwd.cu's qvt_attention_bwd) built from that
  checkout, in turns (parent, change, change, parent), each by CUDA events
  around one call (median of 5) and by device time under torch.profiler (5
  calls); beside them the plain version's one call and SDPA's forward or
  autograd backward by both clocks, and the bound.

    python3 port_scripts/k1b_check.py [--quick] [--parent DIR]
"""
import argparse
import collections
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
from qat_vit_tpu_torch.ops import flash_attention_train as fat  # noqa: E402
from qat_vit_tpu_torch.ops import long_attention as la  # noqa: E402
from qat_vit_tpu_torch.ops._cuda import bwd_scale_f32  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--quick", action="store_true", help="build, report and check; no timing")
ap.add_argument("--parent", help="a checkout of the parent commit to time against")
args = ap.parse_args()

nvcc = _build._nvcc()
for src in ("attention_bwd_mma.cu", "attention_f32.cu"):
    r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                        str(_build.CSRC / src), "-o", os.devnull], capture_output=True, text=True)
    keep = [ln for ln in (r.stdout + r.stderr).splitlines()
            if "error" in ln or "spill" in ln or "registers" in ln or "Compiling entry" in ln]
    print(src, "rc", r.returncode, "\n" + "\n".join(keep), flush=True)
    if r.returncode:
        sys.exit(1)
print("built in", _build.load().build_seconds, "s", flush=True)
card = cs.card_line()
print(card, flush=True)
dev = torch.device("cuda")
bf16 = torch.bfloat16
# chip_smoke's qkv fake-quant grid: its ends clip ~3% of N(0, 1)
FQ = {"qs": torch.tensor([4.2 / 255, 127.0], dtype=torch.float32, device=dev), "in_fq": (0, 255)}


def case(b, n, h, hd, seed, dtype=bf16):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * h * hd)).astype(np.float32)).to(dev)
    do = torch.from_numpy(rng.normal(0, 1, (b, n, h * hd)).astype(np.float32)).to(dev)
    return qkv.to(dtype), do.to(dtype)


def check_b(b, n, h, hd, nv):
    qkv, do = case(b, n, h, hd, n + 7 * hd + b)
    line = f"kernel B [{b}x{n}x{3 * h * hd}] {h}x{hd} n_valid {nv}"
    for kw in ({}, FQ):
        got = fat.attention_bwd(qkv, do, h, hd, n_valid=nv, **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, fat.attention_bwd(qkv, do, h, hd, n_valid=nv, **kw))
        want = fat.attention_bwd_plain(qkv, do, h, hd, n_valid=nv, **kw)
        if nv == 1:  # one key: dq = dk = 0, dv = do on it, exactly
            same = same and torch.equal(got, want)
            line += f"; {'in_fq+ste' if kw else 'float'}: identical to plain {same}"
            continue
        zeros, z_got, z_want = cs.ste_zeros(got, want, qkv, kw)
        _, notes = cs.compare_tc("kernel B", got, want,
                                 la.long_attention_f64(qkv, h, hd, do, n_valid=nv, **kw)[1], 3)
        line += (f"; {'in_fq+ste' if kw else 'float'}: {' | '.join(notes)}; two launches "
                 f"identical {same}; STE zero set identical {zeros} (other zeros kernel "
                 f"{z_got}, plain {z_want})")
        if not (same and zeros):
            print(line, flush=True)
            sys.exit("kernel B: two launches differ or the STE zero set moved")
    print(line, flush=True)


def check_a(b, n, h, hd):
    qkv, _ = case(b, n, h, hd, n + hd)
    line = f"kernel A [{b}x{n}x{3 * h * hd}] {h}x{hd}"
    for kw in ({}, FQ):
        got = fa.attention_fwd(qkv, h, hd, **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, fa.attention_fwd(qkv, h, hd, **kw))
        _, notes = cs.compare_tc("kernel A", got, fa.attention_fwd_plain(qkv, h, hd, **kw),
                                 la.long_attention_f64(qkv, h, hd, **kw)[0], 1)
        line += f"; {'in_fq' if kw else 'float'}: {notes[0]} two launches identical {same}"
        if not same:
            sys.exit("kernel A: two launches differ")
    print(line, flush=True)


def check_f32(b, n, h, hd):
    qkv, do = case(b, n, h, hd, n + hd + 1, torch.float32)
    for kw in ({}, FQ):
        out = fa.attention_fwd(qkv, h, hd, **kw)
        grad = fat.attention_bwd(qkv, do, h, hd, **kw)
        torch.cuda.synchronize()
        same_a = torch.equal(out, fa.attention_fwd_plain(qkv, h, hd, **kw))
        same_b = torch.equal(grad, fat.attention_bwd_plain(qkv, do, h, hd, **kw))
        print(f"f32 [{b}x{n}x{3 * h * hd}] {h}x{hd} {'in_fq' if kw else 'float'}: kernel A "
              f"identical {same_a} ({fa.attention_f32_rows(n, hd)} rows per block), kernel B "
              f"identical {same_b} (rows pass {fa.attention_f32_rows(n, hd, True)} rows per "
              f"block)", flush=True)
        if not (same_a and same_b):
            sys.exit("an f32 kernel differs from its plain version")


for shape in ((32, 197, 6, 64, 197), (256, 197, 6, 64, 197), (2, 1, 2, 64, 1), (3, 6, 2, 64, 1),
              (2, 2, 2, 64, 2), (3, 5, 2, 64, 4),
              (2, 17, 2, 64, 17), (2, 150, 4, 64, 131), (2, 197, 12, 64, 150), (2, 33, 3, 8, 33),
              (2, 97, 2, 32, 90), (2, 130, 2, 72, 130), (2, 77, 2, 128, 77),
              (2, 197, 6, 128, 197), (2, 400, 6, 64, 400), (2, 512, 6, 64, 500),
              (2, 512, 6, 128, 512), (1, 1248, 1, 128, 1248)):
    check_b(*shape)
for shape in ((2, 512, 6, 64), (2, 512, 6, 128)):
    check_a(*shape)
for shape in ((2, 512, 6, 64), (2, 512, 6, 128), (1, 1248, 1, 128), (2, 197, 6, 64)):
    check_f32(*shape)
print("checks ok", flush=True)
if args.quick:
    sys.exit(0)

# ---- the parent commit's f32 kernels A and B, for timing in turns ----
parent = None
if args.parent:
    csrc = os.path.join(args.parent, "qat_vit_tpu_torch", "csrc")
    tmp = tempfile.mkdtemp()
    objs = [os.path.join(tmp, f"{src}.o") for src in ("attention_q", "attention_bwd")]
    for src, obj in zip(("attention_q", "attention_bwd"), objs):
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", csrc, "-c",
                        os.path.join(csrc, f"{src}.cu"), "-o", obj], check=True)
    lib = os.path.join(tmp, "parent.so")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib, *objs], check=True)
    parent = ctypes.CDLL(lib)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    parent.qvt_attention_fwd.argtypes = [P] * 3 + [I] * 5 + [F, I, F, F, P]
    parent.qvt_attention_bwd.argtypes = [P] * 4 + [I] * 5 + [F, I, F, F, P]
    print("parent f32 kernels A and B built from", args.parent, flush=True)


def parent_a(qkv, h, hd, out, fq):
    b, n, _ = qkv.shape
    err = parent.qvt_attention_fwd(qkv.data_ptr(), FQ["qs"].data_ptr() if fq else None,
                                   out.data_ptr(), b, n, h, hd, n,
                                   float(torch.tensor(hd ** -0.5, dtype=torch.float32)), int(fq),
                                   0.0, 255.0, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err


def parent_b(qkv, do, h, hd, out, fq):
    b, n, _ = qkv.shape
    err = parent.qvt_attention_bwd(qkv.data_ptr(), do.data_ptr(),
                                   FQ["qs"].data_ptr() if fq else None, out.data_ptr(), b, n, h,
                                   hd, n, float(bwd_scale_f32(hd, "cpu")), int(fq), 0.0, 255.0,
                                   torch.cuda.current_stream().cuda_stream)
    assert err == 0, err


def by_kernel(fn, runs=20):
    """Device ms per call of each kernel ``fn`` launches, by name."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[cs.kernel_group(e.name)] += e.time_range.elapsed_us() / 1e3 / runs
    return out


def turns(label, fns, work, library):
    """Time ``fns`` ({name: fn}) in turns (parent, change, change, parent
    where a parent is given): CUDA events around one call (chip_smoke's
    ``ms``), the mean of 10 back-to-back calls, and the device time under
    the profiler; print each with the bound and the library call (SDPA's
    backward)."""
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
    split = ", ".join(f"{k} {v:.4f}" for k, v in by_kernel(fns["change"]).items())
    print(f"time {label}: " + ", ".join(
        f"{k} one call {' / '.join(f'{v:.4f}' for v in one[k])} ms (10 back to back "
        f"{' / '.join(f'{v:.4f}' for v in b2b[k])}, device "
        f"{' / '.join(f'{v:.4f}' for v in dev_t[k])})" for k in one)
          + f"; the change's kernels (device ms) {split}; SDPA backward one call {lib:.4f} "
          f"(device {lib_dev:.4f}) ms; bound {bound:.4f} ms ({by}) on {card}", flush=True)


for b in (32, 256):
    n, h, hd = 197, 6, 64
    qkv, do = case(b, n, h, hd, b)
    sdpa = cs.sdpa_backward(torch, qkv, do, h, hd)
    for fq in (False, True):
        kw = FQ if fq else {}
        turns(f"kernel B{' in_fq+ste' if fq else ''} [{b}x{n}x{3 * h * hd}]",
              {"change": lambda kw=kw: fat.attention_bwd(qkv, do, h, hd, **kw)},
              cs.attention_work(b, n, h, hd, backward=True), sdpa)
    del qkv, do, sdpa


def f32_turns(label, fns, plain, work, library):
    """The f32 kernel in ``fns`` ({name: fn}) in turns with the parent's
    (parent, change, change, parent): one call by CUDA events (median of 5)
    and device ms under the profiler (5 calls); the plain version's one call
    and the library call by both clocks; the bound."""
    order = ["parent", "change", "change", "parent"] if "parent" in fns else ["change"]
    one, dev_t = {}, {}
    for k in order:
        one.setdefault(k, []).append(cs.median_ms(fns[k], runs=5, warmup=1))
        dev_t.setdefault(k, []).append(cs.device_ms(torch, fns[k], runs=5))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain()
    end.record()
    end.synchronize()
    lib, lib_dev = cs.median_ms(library, runs=5), cs.device_ms(torch, library, runs=5)
    bound, by = cs.roofline(work)
    split = ", ".join(f"{k} {v:.4f}" for k, v in by_kernel(fns["change"], runs=5).items())
    print(f"time {label}: " + ", ".join(
        f"{k} one call {' / '.join(f'{v:.4f}' for v in one[k])} ms (device "
        f"{' / '.join(f'{v:.4f}' for v in dev_t[k])})" for k in one)
          + f"; the change's kernels (device ms) {split}; plain one call "
          f"{start.elapsed_time(end):.4f} ms; SDPA one call {lib:.4f} (device {lib_dev:.4f}) ms; "
          f"bound {bound:.4f} ms ({by}) on {card}", flush=True)


for b, n, h, hd in cs.F32_ATTENTION_SHAPES:
    qkv, do = case(b, n, h, hd, n + b, torch.float32)
    out, dq = torch.empty(b, n, h * hd, device=dev), torch.empty_like(qkv)
    shape = f"[{b}x{n}x{3 * h * hd}]"
    fwd_lib, bwd_lib = cs.sdpa_forward(torch, qkv, h, hd), cs.sdpa_backward(torch, qkv, do, h, hd)
    for fq in (False, True):
        kw = FQ if fq else {}
        fa_fns = {"change": lambda kw=kw: fa.attention_fwd(qkv, h, hd, **kw)}
        fb_fns = {"change": lambda kw=kw: fat.attention_bwd(qkv, do, h, hd, **kw)}
        if parent is not None:
            fa_fns["parent"] = lambda fq=fq: parent_a(qkv, h, hd, out, fq)
            fb_fns["parent"] = lambda fq=fq: parent_b(qkv, do, h, hd, dq, fq)
            torch.cuda.synchronize()
            for name, fns, got in (("A", fa_fns, out), ("B", fb_fns, dq)):
                fns["parent"]()
                torch.cuda.synchronize()
                if not torch.equal(got, fns["change"]()):
                    sys.exit(f"kernel {name} f32 {shape}: the parent's bits differ")
        tag = " in_fq" if fq else ""
        f32_turns(f"kernel A f32{tag} {shape}", fa_fns,
                  lambda kw=kw: fa.attention_fwd_plain(qkv, h, hd, **kw),
                  cs.attention_work(b, n, h, hd, 4, in_bytes=4, op_type="f32"), fwd_lib)
        f32_turns(f"kernel B f32{tag and ' in_fq+ste'} {shape}", fb_fns,
                  lambda kw=kw: fat.attention_bwd_plain(qkv, do, h, hd, **kw),
                  cs.attention_work(b, n, h, hd, backward=True, in_bytes=4, op_type="f32"),
                  bwd_lib)
    del qkv, do, out, dq, fwd_lib, bwd_lib
print("done", flush=True)
