"""K2d (LayerNorm -> shifted int8, ``ops.fused_serve.ln_quantize``) on one card.

    python3 port_scripts/k2d_check.py [--parent DIR] [--quick]

1. the ptxas report of ``csrc/ln_quantize.cu`` (registers, spills, per kernel);
2. the kernel against ``ln_quantize_plain`` at chip_smoke.py's phase-2 shapes
   (``SHAPES``: ViT-S at batch 32 and 256, the OWLv2-pruned detection forward's
   ``[18440, 576]``, widths 768 and 1,024, a width past the register plan and an
   odd width; bf16 and f32): bit-identical, two launches identical, and the form
   ``ln_quantize_plan`` picks;
3. times, in a fresh process per turn (with ``--parent DIR``, a checkout of the
   parent, e.g. ``git archive`` unpacked into ``runs/``: parent, change, change,
   parent; else the change twice): first the device time per call under
   torch.profiler (20 calls per shape), then CUDA events around one call (median
   of 30) and per call over 10 back to back, the wrapper's host us per call
   (``time.perf_counter`` around each of 300 calls with no synchronisation, the
   median) beside K2a's wrapper (``int8_dense``, the qkv GEMM at batch 32);
   without ``--quick`` also the ViT-S/16 serving forward (chip_smoke.py's phase-3
   export, megamodel chain) at batch 32 and 256 and the OWLv2-pruned detection
   forward at batch 8: a SHA-256 of each output (the turns must agree), the
   K2d kernels' device ms in one profiled forward, and its whole device time.

Prints the card's name and power limit, a line per turn and a JSON line of all.
"""
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# (rows, width): phase 2's shapes
SHAPES = [(6304, 384), (50432, 384), (18440, 576), (6304, 768), (6304, 1024), (6304, 1280),
          (6304, 385)]
QUICK_SHAPES = SHAPES[:3]
CALLS = 300


def ptxas_report(root):
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    src = os.path.join(root, "qat_vit_tpu_torch", "csrc", "ln_quantize.cu")
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                            "-O3", "-Xptxas", "-v", "-I", os.path.dirname(src), "-c", src, "-o",
                            os.path.join(tmp, "k.o")], capture_output=True, text=True)
    lines = [ln for ln in r.stderr.splitlines() if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln]
    print("ptxas (ln_quantize.cu):\n" + "\n".join(lines), flush=True)
    if r.returncode:
        sys.exit(f"nvcc failed:\n{r.stderr[-3000:]}")


def inputs(torch, np, m, n, dtype, seed):
    dev = torch.device("cuda")
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.normal(0.3, 1.5, (m, n)).astype(np.float32)).to(dev).to(dtype)
    ln = {"scale": torch.from_numpy(r.normal(1, 0.2, n).astype(np.float32)).to(dev),
          "bias": torch.from_numpy(r.normal(0, 0.2, n).astype(np.float32)).to(dev)}
    return x, ln, {"scale": torch.tensor(8.0 / 255), "zero_point": torch.tensor(128.0)}


def check(root):
    """Step 2 in this process, on the checkout at ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from qat_vit_tpu_torch.ops import fused_serve as fs

    for m, n in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, ln, out_q = inputs(torch, np, m, n, dtype, m + n)
            got = fs.ln_quantize(x, ln, out_q)
            again = fs.ln_quantize(x, ln, out_q)
            want = fs.ln_quantize_plain(x, ln, out_q)
            torch.cuda.synchronize()
            same, rep = torch.equal(got, want), torch.equal(got, again)
            form = fs.ln_quantize_plan(n, x.element_size(), fs.pointer_align(x))
            diff = int((got.int() - want.int()).abs().max())
            print(f"[{m}x{n}] {str(dtype)[6:]}: form {form} identical {same} (max |diff| {diff}), "
                  f"two launches identical {rep}", flush=True)
            if not (same and rep):
                sys.exit(f"[{m}x{n}] {dtype}: not identical to the plain version")


def child(root, quick):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from qat_vit_tpu_torch import _build
    from qat_vit_tpu_torch.ops import fused_serve as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cases = []
    for m, n in (QUICK_SHAPES if quick else SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"[{m}x{n}] {str(dtype)[6:]}", inputs(torch, np, m, n, dtype, m + n)))
    out = {}
    # device time first, in this fresh process
    for name, (x, ln, q) in cases:
        fs.ln_quantize(x, ln, q)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(20):
                fs.ln_quantize(x, ln, q)
            torch.cuda.synchronize()
        out[name] = {"device_ms": sum(e.time_range.elapsed_us() for e in prof.events()
                                      if e.device_type == torch.autograd.DeviceType.CUDA)
                     / 1e3 / 20}
    for name, (x, ln, q) in cases:
        row = out[name]
        for reps, key in ((1, "event_ms"), (10, "b2b_ms")):
            ts = []
            for _ in range(30):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(reps):
                    fs.ln_quantize(x, ln, q)
                e.record()
                e.synchronize()
                ts.append(s.elapsed_time(e) / reps)
            row[key] = statistics.median(ts)
        row["host_us"] = host_us(torch, lambda: fs.ln_quantize(x, ln, q))
    r = np.random.default_rng(1)
    w = np.clip(np.round(r.normal(0, 20, (384, 1152))), -128, 127).astype(np.int8)
    dev = torch.device("cuda")
    layer = fs.with_packed_weight({
        "w_int8": torch.from_numpy(w).to(dev),
        "w_colsum": torch.from_numpy(w.astype(np.int32).sum(0, dtype=np.int32)).to(dev),
        "bias": torch.from_numpy(r.normal(0, 0.5, 1152).astype(np.float32)).to(dev),
        "w_scale": torch.tensor(0.002)})
    a = torch.from_numpy(r.integers(-128, 128, (32, 197, 384), dtype=np.int8)).to(dev)
    in_q = {"scale": torch.tensor(0.02), "zero_point": torch.tensor(121.0)}
    out["k2a_qkv_host_us"] = host_us(torch, lambda: fs.int8_dense(a, layer, in_q))
    if not quick:
        out.update(forwards(torch, np, fs, acts))
    print("RESULT " + json.dumps(out), flush=True)


def host_us(torch, fn):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(ts) * 1e6


def forwards(torch, np, fs, acts):
    """The serving forwards: output hashes, K2d's device ms and the whole device ms."""
    from qat_vit_tpu_torch.data.pipeline import preprocess_fn
    from qat_vit_tpu_torch.models.registry import create_model, create_student
    from qat_vit_tpu_torch.serve.calibrate import calibrate_detector, ptq_convert
    from qat_vit_tpu_torch.serve.int8_detect import convert_detector, make_int8_detect_forward
    from qat_vit_tpu_torch.serve.int8_vit import export_to_device, int8_apply

    dev = torch.device("cuda")

    def profiled(fn):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        k2d = total = 0.0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = e.time_range.elapsed_us()
                total += us
                k2d += us if "ln_quantize" in e.name else 0.0
        return k2d / 1e3, total / 1e3

    def digest(t):
        return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()).hexdigest()[:16]

    out = {}
    bundle = create_student("vit", generator=torch.Generator().manual_seed(0), device=dev)
    cfg = bundle.cfg
    rng = np.random.default_rng(1)
    prep = preprocess_fn(cfg.image_size, device=dev)
    calib = [prep(torch.from_numpy(rng.integers(0, 256, (32, 32, 32, 3), dtype=np.uint8)))
             for _ in range(4)]
    qp = export_to_device(ptq_convert(bundle.module.state_dict(), calib, cfg, device=dev), dev)
    x = prep(torch.from_numpy(np.random.default_rng(2).integers(0, 256, (256, 32, 32, 3),
                                                                dtype=np.uint8)))
    for b in (32, 256):
        def fn(b=b):
            return int8_apply(qp, x[:b], cfg, fused="megamodel", compute_dtype=torch.bfloat16)
        out[f"serve_{b}"] = (digest(fn()), *profiled(fn))
    del bundle, qp, x
    det = create_model("owlv2_pruned_detector", qat_wrapper=True,
                       generator=torch.Generator().manual_seed(0), device=dev)
    dcfg = det.cfg
    params = {k: v for k, v in det.module.state_dict().items()
              if not k.endswith(("min_val", "max_val"))}

    def det_inputs(seed, b):
        r = np.random.default_rng(seed)
        return (torch.from_numpy(r.normal(0, 1, (b, 768, 768, 3)).astype(np.float32)).to(dev),
                torch.from_numpy(r.normal(0, 1, (b, 4, 512)).astype(np.float32)).to(dev))

    stats = calibrate_detector(params, [det_inputs(10 + i, 1)[0] for i in range(2)], dcfg,
                               device=dev)
    dexp = export_to_device(convert_detector(params, stats, dcfg), dev)
    fwd = make_int8_detect_forward(dcfg, dev)
    dx, dq = det_inputs(20, 8)

    def dfn():
        return fwd(dexp, dx, dq)

    res = dfn()
    out["detect_8"] = ("-".join(digest(res[k]) for k in sorted(res)), *profiled(dfn))
    return out


def main():
    args = sys.argv[1:]
    quick = "--quick" in args
    parent = os.path.abspath(args[args.index("--parent") + 1]) if "--parent" in args else None
    change = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    ptxas_report(change)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--check", change],
                       cwd=change, capture_output=True, text=True)
    print(r.stdout, end="", flush=True)
    if r.returncode:
        sys.exit(f"the check failed (rc {r.returncode}):\n{r.stderr[-3000:]}")
    turns = ([("parent", parent), ("change", change), ("change", change), ("parent", parent)]
             if parent else [("change", change), ("change", change)])
    runs = []
    for who, root in turns:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root]
                           + (["--quick"] if quick else []), cwd=root, capture_output=True,
                           text=True)
        res = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
        if r.returncode or not res:
            sys.exit(f"{who} failed (rc {r.returncode}):\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        rows = json.loads(res[0][len("RESULT "):])
        runs.append([who, rows])
        print(f"{who}: K2a qkv wrapper host {rows['k2a_qkv_host_us']:.1f} us; " + "; ".join(
            f"{case} device {v['device_ms']:.4f} ms, one call {v['event_ms']:.4f}, 10 back to "
            f"back {v['b2b_ms']:.4f}, host {v['host_us']:.1f} us"
            for case, v in rows.items() if isinstance(v, dict)), flush=True)
        for key in ("serve_32", "serve_256", "detect_8"):
            if key in rows:
                h, k2d, total = rows[key]
                print(f"{who}: {key} output {h}, K2d device {k2d:.4f} ms of {total:.3f} ms",
                      flush=True)
    hashes = {key: {tuple(r[1][key])[0] for r in runs}
              for key in ("serve_32", "serve_256", "detect_8") if key in runs[0][1]}
    print("outputs identical across turns: " + ", ".join(
        f"{k} {len(v) == 1}" for k, v in hashes.items()), flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    if any(len(v) != 1 for v in hashes.values()):
        sys.exit("the forwards' outputs differ between turns")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], "--quick" in sys.argv[3:])
    elif sys.argv[1:2] == ["--check"]:
        check(sys.argv[2])
    else:
        main()
