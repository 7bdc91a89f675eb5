"""K9a / K9b, the whole-block cooperative kernels (csrc/megablock.cu), on the
card: against the K4 kernel chain and, with --parent, against the parent
commit in turns.

- the ptxas register and spill report of csrc/megablock.cu and of the chain
  kernels' sources whose stage code it shares (int8_gemm_wgmma.cu,
  int8_gemm.cu, attention_q_mma.cu);
- on a ViT-S/16 export (random init from a seed, PTQ-calibrated on 8
  images): K9a (block 0) and K9b (12 blocks) x and zq identical to the
  megamodel kernel chain (ops.block_kernel.model_forward through the
  kernels) at batch 32 and 256 with a bf16 stream, at batch 32 with an f32
  stream and with n_valid = N - 3, and at 901 tokens (ViT-S/16 at 480 px,
  batch 8; random zq and x); two launches identical;
- then (unless --quick) each checkout in turns (parent, change, change,
  parent), each turn two fresh processes that import the package from its
  checkout and build its kernels there, on the same export:
  - K9a per block and K9b per forward at batch 32 and 256, device ms
    under torch.profiler (20 calls, first in the process), ms per call by
    CUDA events around one call and around 10 back to back (medians of
    30); the wrappers' host us per call at batch 32 (perf_counter around
    each of 300 calls with no synchronisation, the median);
  - block 0 through the chain's four kernels standalone at batch 256 (K2a
    qkv, K3, K2c proj, K2b fc1, K2c fc2), each output compared bit for bit
    with the parent's; each kernel's entry point called with the
    arguments its wrapper passed (captured once; no wrapper host time),
    timed first under torch.profiler (one session, 20 calls of each in
    turn: device ms, no launch gaps) and then by CUDA events around 10
    back-to-back calls (medians of 30).

Run it from the root of a checkout:

    python3 port_scripts/k9_check.py [--quick] [--parent DIR]
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 15
BATCHES = (32, 256)
HOST_CALLS = 300


def vit_s_export(dev, image_size=224, depth=12):
    """(cfg, export on dev, preprocessed images [256, ...]) of a ViT-S/16."""
    from qat_vit_tpu_torch.data.pipeline import preprocess_fn
    from qat_vit_tpu_torch.models.registry import create_student
    from qat_vit_tpu_torch.serve.calibrate import ptq_convert
    from qat_vit_tpu_torch.serve.int8_vit import export_to_device

    bundle = create_student("vit", generator=torch.Generator().manual_seed(SEED), device=dev,
                            image_size=image_size, depth=depth)
    cfg = bundle.cfg
    rng = np.random.default_rng(SEED)
    prep = preprocess_fn(cfg.image_size, device=dev)
    calib = [prep(torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)))]
    export = export_to_device(ptq_convert(bundle.module.state_dict(), calib, cfg, device=dev),
                              dev)
    images = prep(torch.from_numpy(rng.integers(0, 256, (max(BATCHES), 32, 32, 3),
                                                dtype=np.uint8)))
    return cfg, export, images


def stream_in(qp, cfg, images, dt):
    """(zq, x) entering block 0: the patch embedding and LN1 through the kernels."""
    from qat_vit_tpu_torch.ops import fused_serve as fs
    from qat_vit_tpu_torch.serve.int8_vit import _embed

    x = _embed(qp, images, cfg, dt, fs.int8_dense)
    blk0 = qp["blocks"]["0"]
    return fs.ln_quantize(x, blk0["norm1"], blk0["norm1"]["out_q"], eps=cfg.layer_norm_eps), x


def profiled_ms(fns, runs=20):
    """Device ms of one call of each of ``fns`` (each launches one kernel),
    from one torch.profiler session that runs each ``runs`` times in turn;
    None where the session holds another number of kernels than it ran."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for fn in fns:
            for _ in range(runs):
                fn()
        torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.name.startswith(("Memcpy", "Memset")))
    if len(kernels) != runs * len(fns):
        print(f"profiler: {len(kernels)} kernels for {runs * len(fns)} calls", flush=True)
        return [None] * len(fns)
    return [sum(us for _, us in kernels[i * runs:(i + 1) * runs]) / 1e3 / runs
            for i in range(len(fns))]


def child(root, inputs, out_file, what):
    """One checkout's K9 timings (``what`` "k9"), or block 0's stage outputs
    through the chain's kernels and their times ("stages"), written to
    out_file."""
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from qat_vit_tpu_torch import _build
    from qat_vit_tpu_torch.ops import block_kernel as bk
    from qat_vit_tpu_torch.ops import flash_attention as fa
    from qat_vit_tpu_torch.ops import fused_serve as fs
    from qat_vit_tpu_torch.serve.int8_vit import export_to_device

    dev = torch.device("cuda")
    saved = torch.load(inputs, weights_only=False)
    cfg, images = saved["cfg"], saved["images"].to(dev)
    qp = export_to_device(saved["export"], dev)
    kw = dict(num_heads=cfg.num_heads, head_dim=cfg.head_dim, eps=cfg.layer_norm_eps)
    blk0, nxt = qp["blocks"]["0"], qp["blocks"]["1"]["norm1"]
    res = {"k9": {}, "host_us": {}, "stages": {}, "stages_device": {}}
    for b in BATCHES if what == "k9" else ():
        zq, x = stream_in(qp, cfg, images[:b], torch.bfloat16)
        n = zq.shape[1]
        fns = {"K9a": lambda: bk.megablock_forward(zq, x, blk0, nxt, n_valid=n, **kw),
               "K9b": lambda: bk.megamodel_res_forward(zq, x, qp["blocks"], qp["norm"],
                                                       depth=cfg.depth, n_valid=n, **kw)}
        for name, fn in fns.items():
            res["k9"][f"{name} batch {b}"] = {"device_ms": cs.device_ms(torch, fn),
                                              "ms": cs.median_ms(fn, runs=30),
                                              "ms10": cs.median_ms(fn, runs=30, reps=10)}
        if b == 32:
            for name, fn in fns.items():
                fn()
                torch.cuda.synchronize()
                times = []
                for _ in range(HOST_CALLS):
                    t0 = time.perf_counter()
                    fn()
                    times.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                res["host_us"][f"{name} batch {b}"] = 1e6 * statistics.median(times)
    if what == "k9":
        with open(out_file, "w") as f:
            json.dump(res, f)
        return
    # block 0 through the chain's kernels, stage by stage, at batch 256
    zq, x = stream_in(qp, cfg, images[:256], torch.bfloat16)
    n = zq.shape[1]
    outs = {}
    stages = [
        ("K2a qkv", lambda: fs.int8_dense(zq, blk0["qkv"], blk0["norm1"]["out_q"],
                                          out_dtype=torch.bfloat16)),
        ("K3", lambda: fa.fused_attention_qkv(outs["K2a qkv"], cfg.num_heads, cfg.head_dim,
                                              out_q=blk0["qkv"]["out_q"], n_valid=n)),
        ("K2c proj", lambda: fs.int8_dense_resid_ln_q(
            outs["K3"], blk0["proj"], blk0["qkv"]["out_q"], x, blk0["norm2"],
            blk0["norm2"]["out_q"], eps=cfg.layer_norm_eps, out_dtype=torch.float32)),
        ("K2b fc1", lambda: fs.int8_dense_gelu_q(
            outs["K2c proj"][1], blk0["fc1"], bk._recip_scale_q(blk0["norm2"]["out_q"]),
            blk0["gelu_q"])),
        ("K2c fc2", lambda: fs.int8_dense_resid_ln_q(
            outs["K2b fc1"], blk0["fc2"], bk._recip_scale_q(blk0["gelu_q"]), outs["K2c proj"][0],
            nxt, nxt["out_q"], eps=cfg.layer_norm_eps, out_dtype=torch.bfloat16)),
    ]
    lib = _build.load()
    entries = {}
    for name, fn in stages:
        calls = []

        class Capture:  # the wrapper's launch, recorded as it goes through
            def call(self, entry, *args):
                calls.append((entry, args))
                lib.call(entry, *args)

        _build.load = Capture
        try:
            outs[name] = fn()
        finally:
            _build.load = lambda: lib
        (entry, args), = calls
        entries[name] = lambda entry=entry, args=args: lib.call(entry, *args)
    res["stages_device"] = dict(zip(entries, profiled_ms(list(entries.values()))))
    for name, fn in entries.items():
        res["stages"][name] = cs.median_ms(fn, runs=30, reps=10)
    torch.save({k: (v if isinstance(v, tuple) else (v,)) for k, v in outs.items()},
               out_file + ".pt")
    with open(out_file, "w") as f:
        json.dump(res, f)


def ptxas_report():
    from qat_vit_tpu_torch import _build

    nvcc = _build._nvcc()
    for src in ("megablock.cu", "int8_gemm_wgmma.cu", "int8_gemm.cu", "attention_q_mma.cu"):
        t0 = time.perf_counter()
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC),
                            "-c", str(_build.CSRC / src), "-o", os.devnull],
                           capture_output=True, text=True)
        lines = (r.stdout + r.stderr).splitlines()
        keep, entry, spill = [], "", ""
        for ln in lines:  # one line per kernel: its (mangled) name, spills, registers
            if "error" in ln:
                keep.append(ln)
            elif "Compiling entry function" in ln:
                entry = ln.split("'")[1][:90]
            elif "spill" in ln:
                spill = ln.strip()
            elif "Used" in ln and "registers" in ln:
                keep.append(f"  {entry}: {ln.split('Used')[1].split(',')[0].strip()}; {spill}")
        print(f"{src} rc {r.returncode} ({time.perf_counter() - t0:.0f} s)\n" + "\n".join(keep),
              flush=True)
        if r.returncode:
            print("\n".join(lines[-40:]), flush=True)
            sys.exit(1)


def check_identical(dev):
    """K9a / K9b against the kernel chain: exits on the first difference."""
    import ctypes

    from qat_vit_tpu_torch import _build
    from qat_vit_tpu_torch.ops import block_kernel as bk

    cfg, qp, images = vit_s_export(dev)
    kw = dict(num_heads=cfg.num_heads, head_dim=cfg.head_dim, eps=cfg.layer_norm_eps)
    blk0, nxt = qp["blocks"]["0"], qp["blocks"]["1"]["norm1"]
    cases = []
    for b, dt, cut in ((32, torch.bfloat16, 0), (256, torch.bfloat16, 0), (32, torch.float32, 0),
                       (32, torch.bfloat16, 3)):
        zq, x = stream_in(qp, cfg, images[:b], dt)
        cases.append((f"batch {b} {str(dt)[6:]} x n_valid N - {cut}", zq, x, zq.shape[1] - cut))
    g = np.random.default_rng(SEED + 1)
    n901 = (480 // 16) ** 2 + 1
    zq = torch.from_numpy(g.integers(-128, 128, (8, n901, 384), dtype=np.int8)).to(dev)
    x = torch.from_numpy(g.normal(0, 1, (8, n901, 384)).astype(np.float32)).to(dev)
    cases.append(("ViT-S/16 480 px, 901 tokens, batch 8", zq, x.to(torch.bfloat16), n901))
    res = (ctypes.c_int * 6)()
    for label, zq, x, nv in cases:
        n = zq.shape[1]
        _build.load().call("qvt_megablock_residency", n, cfg.num_heads, cfg.head_dim,
                           int(x.dtype == torch.bfloat16), ctypes.addressof(res))
        for name, k9, chain in (
                ("K9a", lambda: bk.megablock_forward(zq, x, blk0, nxt, n_valid=nv, **kw),
                 lambda: bk.block_forward(zq, x, blk0, nxt, n_valid=nv, **kw)),
                ("K9b", lambda: bk.megamodel_res_forward(zq, x, qp["blocks"], qp["norm"],
                                                         depth=cfg.depth, n_valid=nv, **kw),
                 lambda: bk.model_forward(zq, x, qp["blocks"], qp["norm"], depth=cfg.depth,
                                          n_valid=nv, **kw))):
            got, want = k9(), chain()
            again = k9()
            torch.cuda.synchronize()
            same = all(torch.equal(a, w) for a, w in zip(got, want))
            twice = all(torch.equal(a, w) for a, w in zip(got, again))
            diffs = [float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)]
            print(f"{name} {label}: x, zq identical to the megamodel kernel chain {same} "
                  f"(max |diff| x {diffs[0]:.3e}, zq {diffs[1]:.0f}), two launches identical "
                  f"{twice}; {res[0]} blocks of {res[2]} threads per SM x {res[1]} SMs, "
                  f"{res[3]} bytes of shared memory, K2c rows {res[4]}, K3 resident {res[5]}",
                  flush=True)
            if not (same and twice):
                sys.exit(f"{name} {label}: differs")
    return cfg, qp, images


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="build, report and check; no timing")
    ap.add_argument("--parent", help="a checkout of the parent commit to time against")
    ap.add_argument("--child", nargs=4, metavar=("ROOT", "INPUTS", "OUT", "WHAT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(*args.child)
        return
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    ptxas_report()
    cfg, qp, images = check_identical(dev)
    if args.quick:
        print(f"done (--quick) on {card}", flush=True)
        return

    from qat_vit_tpu_torch.serve.int8_vit import export_to_device

    tmp = tempfile.mkdtemp()
    inputs = os.path.join(tmp, "inputs.pt")
    cpu = export_to_device(qp, "cpu")
    for blk in cpu["blocks"].values():  # the packed copies are made again on the card
        for layer in blk.values():
            if isinstance(layer, dict):
                layer.pop("w_int8_t", None)
    torch.save({"cfg": cfg, "export": cpu, "images": images.cpu()}, inputs)
    del qp
    torch.cuda.empty_cache()
    roots = {"change": os.getcwd()}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    order = ["parent", "change", "change", "parent"] if args.parent else ["change"]
    runs, outputs = {}, {}
    for i, who in enumerate(order):
        t0 = time.perf_counter()
        turn = {}
        for what in ("k9", "stages"):
            out = os.path.join(tmp, f"{i}_{who}_{what}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--child", roots[who],
                            inputs, out, what], check=True)
            with open(out) as f:
                turn.update({k: v for k, v in json.load(f).items() if v})
        runs.setdefault(who, []).append(turn)
        outputs.setdefault(who, out + ".pt")
        print(f"turn {i + 1} ({who}) done in {time.perf_counter() - t0:.0f} s", flush=True)
    if args.parent:
        p_out = torch.load(outputs["parent"])
        c_out = torch.load(outputs["change"])
        for name in p_out:
            same = all(torch.equal(a, b) for a, b in zip(p_out[name], c_out[name]))
            print(f"{name} batch 256: outputs identical to the parent's {same}", flush=True)
    for key in runs["change"][0]["k9"]:
        print(f"{key}: " + "; ".join(
            f"{who} device ms {' / '.join(f'{r['k9'][key]['device_ms']:.4f}' for r in rs)}, "
            f"one call {' / '.join(f'{r['k9'][key]['ms']:.4f}' for r in rs)}, "
            f"10 back to back {' / '.join(f'{r['k9'][key]['ms10']:.4f}' for r in rs)}"
            for who, rs in runs.items()), flush=True)
    def ms(v):
        return "dropped" if v is None else f"{v:.4f}"

    for key in runs["change"][0]["stages"]:
        print(f"{key} batch 256, device ms (torch.profiler): " + "; ".join(
            f"{who} {' / '.join(ms(r['stages_device'][key]) for r in rs)}"
            for who, rs in runs.items())
            + "; ms per call over 10 back to back: " + "; ".join(
            f"{who} {' / '.join(ms(r['stages'][key]) for r in rs)}"
            for who, rs in runs.items()), flush=True)
    for key in runs["change"][0]["host_us"]:
        print(f"{key} wrapper host us per call: " + "; ".join(
            f"{who} {' / '.join(f'{r['host_us'][key]:.1f}' for r in rs)}"
            for who, rs in runs.items()), flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    print(f"done on {card}", flush=True)


if __name__ == "__main__":
    main()
