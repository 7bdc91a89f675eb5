"""Full-budget detection KD evidence run: float -> QAT -> int8 at real scale
(port of ``scripts/detect_loop.py``).

The detection analog of ``accuracy_loop``: distill the OWLv2-base detection
teacher into the pruned student at the reference's detection resolution (768
px, ref model_registry.py:282-327), through the full phase machine — float
KD epochs -> QAT epochs -> convert -> true-int8 detection eval — recording
per-epoch teacher-agreement metrics (mean |Δbox|, top-box agreement),
training throughput, and the fake-quant -> int8 agreement deltas. Also
measures the teacher-output-cache throughput delta.

Without a network the images are the hard synthetic CIFAR-10 stand-in
upscaled on the device to 768 px, and the teacher detector is randomly
initialized (the HF ``google/owlv2-base-patch16-ensemble`` download needs
one; ``validate_real --owlv2-ckpt`` converts a checkpoint on disk). The
numbers measure the pipeline — KD convergence toward a fixed teacher,
quantization fidelity, and throughput — not real-detection mAP.

Phases are idempotent (skipped when their artifact exists):
  data         workdir/data/cifar10.npz
  cache_delta  workdir/cache_delta.json   (teacher-cache on/off img/s)
  final        workdir/final/             (detect_train_main artifacts)
  report       workdir/REPORT_detect.md + REPORT_detect.json

    python -m qat_vit_tpu_torch.scripts.detect_loop --workdir /tmp/detect_loop
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np

from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10_hard
from qat_vit_tpu_torch.train.config import DEFAULT_HPARAMS
from qat_vit_tpu_torch.train.detect_trainer import DetectKDTrainer, detect_train_main
from qat_vit_tpu_torch.train.trainer import entry_device

logger = logging.getLogger("detect_loop")


def phase_data(workdir: str, seed: int, n_train: int = 50_000,
               n_test: int = 10_000) -> str:
    data_dir = os.path.join(workdir, "data")
    npz = os.path.join(data_dir, "cifar10.npz")
    if os.path.isfile(npz):
        return data_dir
    os.makedirs(data_dir, exist_ok=True)
    logger.info("generating hard synthetic CIFAR-10 (%d/%d) ...",
                n_train, n_test)
    splits = synthetic_cifar10_hard(n_train, n_test, seed=seed)
    np.savez_compressed(npz + ".tmp.npz", **splits)
    os.replace(npz + ".tmp.npz", npz)
    return data_dir


def _hp(args, data_dir: str, **over):
    hp = dict(DEFAULT_HPARAMS)
    hp.update(
        task="detection", image_size=args.image_size,
        batch_size=args.batch_size, eval_batch_size=args.batch_size,
        epochs=args.epochs, qat_start_epoch=args.qat_start_epoch,
        limit_eval_batches=args.limit_eval_batches,
        data_dir=data_dir, seed=args.seed,
        mlflow_uri=f"sqlite:///{args.workdir}/mlflow.db",
        experiment="clue-vit-qat-detect",
        output_dir=os.path.join(args.workdir, "final"),
    )
    if args.micro:
        # CI/CPU smoke of the phase plumbing (never used for real numbers)
        hp.update(patch_size=8, embed_dim=64, depth=2, num_heads=2,
                  mlp_ratio=2.0, num_queries=3, text_dim=64)
    hp.update(over)
    return hp


def phase_cache_delta(args, data_dir: str, device="cuda") -> dict:
    """Teacher-output cache on/off: one bounded epoch each, same seed/data.

    The per-step teacher detection forward at 768 px is the single heaviest
    removable op of the detect train step — measure it."""
    path = os.path.join(args.workdir, "cache_delta.json")
    if os.path.isfile(path):
        with open(path) as f:
            return json.load(f)
    out = {}
    for cache in (True, False):
        hp = _hp(args, data_dir, cache_teacher_logits=cache, epochs=1)
        t0 = time.perf_counter()
        trainer = DetectKDTrainer(hp, device=device)
        # warm: first steps, and (cache on) fill the visited rows so the
        # timed epoch measures the steady state (all cache hits) — epoch 0's
        # shuffle is deterministic, so the same batches revisit
        trainer.train_epoch(0, limit_batches=2)
        if cache:
            trainer.train_epoch(0, limit_batches=args.delta_batches)
        tm = trainer.train_epoch(0, limit_batches=args.delta_batches)
        key = "cache_on" if cache else "cache_off"
        out[key] = {
            "imgs_per_sec": tm["imgs_per_sec"],
            "epoch_seconds": tm["epoch_seconds"],
            "batches": args.delta_batches,
            "wall_with_setup": time.perf_counter() - t0,
        }
        logger.info("%s: %.1f img/s", key, tm["imgs_per_sec"])
        del trainer
    out["speedup"] = (
        out["cache_on"]["imgs_per_sec"] / out["cache_off"]["imgs_per_sec"]
    )
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    return out


def phase_final(args, data_dir: str, device="cuda") -> dict:
    """The full-budget detection KD run through detect_train_main."""
    final_dir = os.path.join(args.workdir, "final")
    marker = os.path.join(final_dir, "RESULTS.json")
    if os.path.isfile(marker):
        with open(marker) as f:
            return json.load(f)
    hp = _hp(args, data_dir)
    out = detect_train_main(hp, device=device)
    payload = {
        "results": out["results"],
        "int8": out["int8"],
        "hp": {k: v for k, v in hp.items() if not isinstance(v, dict)},
    }
    with open(marker, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    return payload


def phase_report(args, cache_delta: dict, final: dict) -> None:
    rpt_json = os.path.join(args.workdir, "REPORT_detect.json")
    rpt_md = os.path.join(args.workdir, "REPORT_detect.md")
    payload = {"cache_delta": cache_delta, "final": final,
               "image_size": args.image_size, "batch_size": args.batch_size}
    with open(rpt_json, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    rows = final["results"]
    lines = [
        "# Detection KD+QAT full-budget run",
        "",
        f"OWLv2-base teacher -> pruned student @ {args.image_size}px, "
        f"batch {args.batch_size}, {args.epochs} epochs "
        f"(QAT from epoch {args.qat_start_epoch}); synthetic-hard images, "
        "random-init teacher (zero egress — see module docstring).",
        "",
        "| epoch | train_loss | box_err | teacher_agreement | img/s | QAT |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['epoch']} | {r.get('train_loss', 0):.4f} "
            f"| {r['box_err']:.4f} | {r['teacher_agreement']:.4f} "
            f"| {r['imgs_per_sec']:.0f} | "
            f"{'y' if r.get('qat_enabled', True) else ''} |"
        )
    i8 = final["int8"]
    lines += [
        "",
        f"int8 vs fake-quant: box_err {i8.get('int8_box_err', float('nan')):.5f}, "
        f"top-box agreement {i8.get('int8_top_box_agreement', float('nan')):.4f}",
        "",
        f"Teacher-output cache delta ({cache_delta['cache_on']['batches']} "
        f"batches): {cache_delta['cache_on']['imgs_per_sec']:.1f} img/s on vs "
        f"{cache_delta['cache_off']['imgs_per_sec']:.1f} off = "
        f"x{cache_delta['speedup']:.2f}",
    ]
    with open(rpt_md, "w") as f:
        f.write("\n".join(lines) + "\n")
    logger.info("wrote %s", rpt_md)


def main(argv=None, device="cuda"):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="/tmp/detect_loop")
    p.add_argument("--image-size", type=int, default=768)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--qat-start-epoch", type=int, default=3)
    p.add_argument("--delta-batches", type=int, default=60)
    p.add_argument("--limit-eval-batches", type=int, default=0,
                   help="cap per-epoch eval batches (0 = full test set); "
                        "the detection eval runs the TEACHER too")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--micro", action="store_true",
                   help="micro geometry smoke of the phase plumbing (CPU)")
    p.add_argument("--phase", default="all",
                   choices=["all", "data", "cache_delta", "final"])
    args = p.parse_args(argv)
    device = entry_device(device)
    os.makedirs(args.workdir, exist_ok=True)
    if args.micro:
        data_dir = phase_data(args.workdir, args.seed, 512, 128)
    else:
        data_dir = phase_data(args.workdir, args.seed)
    if args.phase == "data":
        return
    delta = phase_cache_delta(args, data_dir, device=device)
    if args.phase == "cache_delta":
        return
    final = phase_final(args, data_dir, device=device)
    phase_report(args, delta, final)


if __name__ == "__main__":  # pragma: no cover
    main()
