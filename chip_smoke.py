#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``qat_vit_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero with no result):

1. environment: the card's name and power limit (nvidia-smi), torch/CUDA
   versions, and the time to build the kernels from ``qat_vit_tpu_torch/csrc``;
2. kernels against their plain PyTorch versions on the card, at ViT-S/16
   shapes with batch 32, each timed (CUDA events, median of 30 runs after
   warm-up) beside its plain version;
3. end to end: a random-init ViT-S/16 student (224 px, 10 classes), PTQ over
   4 calibration batches of 32, then ``Int8Predictor`` on 512 uint8 32x32
   images at batch 256 through the kernels; checks the kernels' launch
   counts, finite logits, agreement with the same chain through the plain
   versions and with the exact f32 path, and prints the serving img/s.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Needs a CUDA device; with none it exits 2.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
B_KERNEL = 32  # batch of the phase-2 kernel checks
CALIB_BATCHES, CALIB_B = 4, 32
N_IMAGES, SERVE_B = 512, 256
TIMING_RUNS = 30
# int8 outputs: a rounding-boundary flip (op order, tanh/exp ulps) may move
# an element by one step; at least this share must be exact
INT8_MIN_EXACT = 0.999
# megamodel chain through the kernels vs through their plain versions
CHAIN_REL_L2 = 2e-2
# megamodel chain (bf16 stream, tanh-GELU, multiply-quantize) vs the exact
# f32 path (erf-GELU, divide-quantize): ~2.5e-2 on the micro model
EXACT_REL_L2 = 0.2


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, runs: int = TIMING_RUNS) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_int8(name, got, want):
    import torch

    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    exact = float((diff == 0).float().mean())
    worst = int(diff.max())
    if worst > 1 or exact < INT8_MIN_EXACT:
        fail(f"{name}: int8 max |diff| {worst}, exact share {exact:.6f}")
    return float(worst), exact


def compare_float(name, got, want, rtol):
    import torch

    got, want = got.to(torch.float32), want.to(torch.float32)
    err = (got - want).abs()
    bound = rtol * (1.0 + want.abs())
    if not torch.isfinite(got).all() or bool((err > bound).any()):
        fail(f"{name}: max |diff| {float(err.max()):.3e} beyond rtol {rtol}")
    return float(err.max())


def phase_kernels(torch, np, fs, fa):
    """Each kernel against its plain version at ViT-S shapes, batch 32."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    n_tok, d, mlp, heads, hd = 197, 384, 1536, 6, 64

    def act_int8(*shape):
        return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(dev)

    def layer(k, n, per_channel=False):
        w = np.clip(np.round(rng.normal(0, 20, (k, n))), -128, 127).astype(np.int8)
        ws = (torch.from_numpy(rng.uniform(1e-3, 3e-3, n).astype(np.float32)).to(dev)
              if per_channel else torch.tensor(0.002))
        return {
            "w_int8": torch.from_numpy(w).to(dev),
            "w_colsum": torch.from_numpy(w.astype(np.int32).sum(0, dtype=np.int32)).to(dev),
            "bias": torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)).to(dev),
            "w_scale": ws,
        }

    def ln(n):
        return {"scale": torch.from_numpy(rng.normal(1, 0.2, n).astype(np.float32)).to(dev),
                "bias": torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32)).to(dev)}

    in_q = {"scale": torch.tensor(0.02), "zero_point": torch.tensor(121.0)}
    out_q = {"scale": torch.tensor(8.0 / 255), "zero_point": torch.tensor(128.0)}
    gelu_q = {"scale": torch.tensor(4.0 / 255), "zero_point": torch.tensor(11.0)}
    bf16 = torch.bfloat16
    b = B_KERNEL
    x_bf16 = torch.from_numpy(rng.normal(0, 1.5, (b, n_tok, d)).astype(np.float32)).to(dev).to(bf16)
    x_f32 = torch.from_numpy(rng.normal(0, 1.5, (b, n_tok, d)).astype(np.float32)).to(dev)
    qkv = torch.from_numpy(rng.normal(0, 1.0, (b, n_tok, 3 * d)).astype(np.float32)).to(dev).to(bf16)
    cases = [
        # name, wrapper, plain, args, kwargs, replaces
        ("int8_gemm:plain qkv [6304x384]@[384x1152]", fs.int8_dense, fs.int8_dense_plain,
         (act_int8(b, n_tok, d), layer(d, 3 * d), in_q), {"out_dtype": bf16},
         "qat_vit_tpu/ops/fused_serve.py:57"),
        ("int8_gemm:resid_ln_q proj [6304x384]@[384x384]", fs.int8_dense_resid_ln_q,
         fs.int8_dense_resid_ln_q_plain,
         (act_int8(b, n_tok, d), layer(d, d), in_q, x_bf16, ln(d), out_q),
         {"out_dtype": torch.float32}, "qat_vit_tpu/ops/fused_serve.py:87"),
        ("int8_gemm:gelu_q fc1 [6304x384]@[384x1536]", fs.int8_dense_gelu_q,
         fs.int8_dense_gelu_q_plain, (act_int8(b, n_tok, d), layer(d, mlp), in_q, gelu_q), {},
         "qat_vit_tpu/ops/fused_serve.py:70"),
        ("int8_gemm:resid_ln_q fc2 [6304x1536]@[1536x384]", fs.int8_dense_resid_ln_q,
         fs.int8_dense_resid_ln_q_plain,
         (act_int8(b, n_tok, mlp), layer(mlp, d), in_q, x_f32, ln(d), out_q),
         {"out_dtype": bf16}, "qat_vit_tpu/ops/fused_serve.py:87"),
        ("int8_gemm:plain patch_embed [6272x768]@[768x384]", fs.int8_dense, fs.int8_dense_plain,
         (act_int8(b, n_tok - 1, 768), layer(768, d), in_q), {"out_dtype": bf16},
         "qat_vit_tpu/ops/fused_serve.py:57"),
        ("int8_gemm:plain head [32x384]@[384x10] per-channel", fs.int8_dense,
         fs.int8_dense_plain, (act_int8(b, d), layer(d, 10, per_channel=True), in_q),
         {"out_dtype": torch.float32}, "qat_vit_tpu/ops/fused_serve.py:57"),
        ("ln_quantize [6304x384] bf16", fs.ln_quantize, fs.ln_quantize_plain,
         (x_bf16, ln(d), out_q), {}, "qat_vit_tpu/ops/fused_serve.py:105"),
        ("attention_q [32x197x1152] 6 heads", fa.fused_attention_qkv,
         fa.fused_attention_qkv_plain, (qkv, heads, hd), {"out_q": out_q},
         "qat_vit_tpu/ops/flash_attention.py:125"),
    ]
    results = []
    for name, kernel, plain, args, kwargs, replaces in cases:
        got = kernel(*args, **kwargs)
        want = plain(*args, **kwargs)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs, exact = [], []
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"{name}: kernel gives {g.dtype}{tuple(g.shape)}, plain {w.dtype}{tuple(w.shape)}")
            if g.dtype == torch.int8:
                worst, share = compare_int8(name, g, w)
                errs.append(worst)
                exact.append(f"int8 exact {share:.7f}")
            else:
                # f32 out: same f32 ops in the same order; bf16 out: one bf16 ulp
                errs.append(compare_float(name, g, w, 2 ** -7 if g.dtype == bf16 else 1e-5))
        ms = median_ms(lambda: kernel(*args, **kwargs))
        plain_ms = median_ms(lambda: plain(*args, **kwargs))
        print(f"phase 2 {name}: max|diff| {max(errs):.3e} {' '.join(exact)}  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms", flush=True)
        results.append({"name": name, "wrapper": kernel, "replaces": replaces,
                        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms})
    return results


def phase_end_to_end(torch, np, fs, fa):
    from qat_vit_tpu_torch.data.pipeline import preprocess_fn
    from qat_vit_tpu_torch.models.registry import create_student
    from qat_vit_tpu_torch.serve.calibrate import ptq_convert
    from qat_vit_tpu_torch.serve.int8_vit import int8_apply
    from qat_vit_tpu_torch.serve.predictor import Int8Predictor

    dev = torch.device("cuda")
    bundle = create_student("vit", generator=torch.Generator().manual_seed(SEED), device=dev)
    cfg = bundle.cfg
    if (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.image_size, cfg.num_classes) != (384, 12, 6, 224, 10):
        fail(f"unexpected student geometry {cfg}")
    rng = np.random.default_rng(SEED + 1)
    prep = preprocess_fn(cfg.image_size, device=dev)
    calib = [prep(torch.from_numpy(rng.integers(0, 256, (CALIB_B, 32, 32, 3), dtype=np.uint8)))
             for _ in range(CALIB_BATCHES)]
    t0 = time.perf_counter()
    export = ptq_convert(bundle.module.state_dict(), calib, cfg, device=dev)
    torch.cuda.synchronize()
    print(f"phase 3 ptq_convert over {CALIB_BATCHES}x{CALIB_B} images: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    images = np.random.default_rng(SEED + 2).integers(0, 256, (N_IMAGES, 32, 32, 3), dtype=np.uint8)
    pred = Int8Predictor(export, cfg, batch_size=SERVE_B, device=dev)
    if pred.options.get("fused") != "megamodel":
        fail(f"serving preset on CUDA is {pred.options}, expected the megamodel chain")
    wrappers = {"int8_gemm": (fs.int8_dense, fs.int8_dense_gelu_q, fs.int8_dense_resid_ln_q),
                "ln_quantize": (fs.ln_quantize,), "attention_q": (fa.fused_attention_qkv,)}
    for group in wrappers.values():
        for w in group:
            w.launches = 0
    logits = pred.logits(images)
    torch.cuda.synchronize()
    launches = {w: w.launches for group in wrappers.values() for w in group}
    for kernel, group in wrappers.items():
        total = sum(launches[w] for w in group)
        print(f"phase 3 launches {kernel}: {total} "
              f"({', '.join(f'{w.__name__} {launches[w]}' for w in group)})", flush=True)
        if total == 0 or any(launches[w] == 0 for w in group):
            fail(f"the serving path did not launch every {kernel} kernel: {launches}")
    if logits.shape != (N_IMAGES, cfg.num_classes) or not np.isfinite(logits).all():
        fail(f"logits {logits.shape}, finite {np.isfinite(logits).all()}")

    ref_chain, ref_exact = [], []
    for start in range(0, N_IMAGES, SERVE_B):
        x = prep(torch.from_numpy(images[start:start + SERVE_B]))
        ref_chain.append(int8_apply(pred.qparams, x, cfg, fused="megamodel_plain",
                                    compute_dtype=torch.bfloat16).cpu().numpy())
        ref_exact.append(int8_apply(pred.qparams, x, cfg, fused="none").cpu().numpy())
    ref_chain, ref_exact = np.concatenate(ref_chain), np.concatenate(ref_exact)
    rel_chain = float(np.linalg.norm(logits - ref_chain) / np.linalg.norm(ref_chain))
    rel_exact = float(np.linalg.norm(logits - ref_exact) / np.linalg.norm(ref_exact))
    top1_chain = float((logits.argmax(-1) == ref_chain.argmax(-1)).mean())
    top1_exact = float((logits.argmax(-1) == ref_exact.argmax(-1)).mean())
    print(f"phase 3 logits vs plain megamodel chain on the card: rel L2 {rel_chain:.3e} "
          f"(bound {CHAIN_REL_L2}), top-1 agreement {top1_chain:.4f}", flush=True)
    print(f"phase 3 logits vs exact f32 path: rel L2 {rel_exact:.3e} (bound {EXACT_REL_L2}), "
          f"top-1 agreement {top1_exact:.4f}", flush=True)
    if rel_chain > CHAIN_REL_L2:
        fail(f"kernel chain vs plain chain rel L2 {rel_chain:.3e} > {CHAIN_REL_L2}")
    if rel_exact > EXACT_REL_L2:
        fail(f"kernel chain vs exact path rel L2 {rel_exact:.3e} > {EXACT_REL_L2}")

    # serving rate: pipelined stream of batch-256 uint8 batches, host clock
    # around work that ends in a synchronize (record, not a gate)
    batches = [images[:SERVE_B], images[SERVE_B:]] * 4
    for _ in pred.serve_stream(batches[:2]):
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(len(out) for out in pred.serve_stream(batches))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"phase 3 serving: {n / dt:.1f} img/s at batch {SERVE_B} "
          f"({n} images in {dt * 1e3:.1f} ms) on {card_line()}", flush=True)
    return launches


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA GPU",
              file=sys.stderr)
        sys.exit(2)
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "qat_vit_tpu_torch", "csrc")):
        fail(f"no qat_vit_tpu_torch/csrc beside {__file__}: run it from a checkout of the repository")
    sys.path.insert(0, root)
    from qat_vit_tpu_torch import _build
    from qat_vit_tpu_torch.ops import flash_attention as fa
    from qat_vit_tpu_torch.ops import fused_serve as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)

    # phase 1: environment and build
    card = card_line()
    print(card, flush=True)
    print(f"phase 1 torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    lib = _build.load()
    print(f"phase 1 kernels built in {lib.build_seconds:.1f} s: {lib.path.name}", flush=True)

    kernels = phase_kernels(torch, np, fs, fa)
    launches = phase_end_to_end(torch, np, fs, fa)

    sources = {fs.int8_dense: "qat_vit_tpu_torch/csrc/int8_gemm.cu",
               fs.int8_dense_gelu_q: "qat_vit_tpu_torch/csrc/int8_gemm.cu",
               fs.int8_dense_resid_ln_q: "qat_vit_tpu_torch/csrc/int8_gemm.cu",
               fs.ln_quantize: "qat_vit_tpu_torch/csrc/ln_quantize.cu",
               fa.fused_attention_qkv: "qat_vit_tpu_torch/csrc/attention_q.cu"}
    record = {"kernels": [
        {"name": k["name"], "route": "cuda", "source": sources[k["wrapper"]],
         "replaces": k["replaces"], "launches": launches[k["wrapper"]],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"]}
        for k in kernels
    ]}
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
