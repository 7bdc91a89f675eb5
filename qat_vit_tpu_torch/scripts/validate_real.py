"""One-command real-data validation (port of ``scripts/validate_real.py``).

The one reference capability that needs files from outside is the
real-weights / real-data accuracy anchor: the reference's teacher is the HF
checkpoint ``edadaltocg/vit_base_patch16_224_in21k_ft_cifar10`` on real
CIFAR-10 (reference src/models/model_registry.py:186-189,
src/training/qat_trainer.py:210-219). Pointed at real artifacts on disk,
this script

  1. loads CIFAR-10 from --data-dir (any supported on-disk format) and
     REFUSES to proceed on the synthetic fallback (unless --allow-synthetic);
  2. converts the torch teacher checkpoint (.pth/.bin HF/timm layout, strict:
     every checkpoint key must be consumed) or loads a converted .msgpack;
  3. runs the fp32 teacher over the full test set -> the real-data anchor
     top-1 (the HF card reports ~98 % for the reference teacher);
  4. optionally does the same smoke for an OWLv2 detection checkpoint
     (HF ``Owlv2ForObjectDetection`` state dict -> the port's detector forward);
  5. with --full-loop, stages the data + teacher into the accuracy-loop
     layout and runs the complete search -> KD+QAT -> convert -> int8 loop
     (``scripts/accuracy_loop.py``) against the REAL artifacts;
  6. writes REPORT_real.md / REPORT_real.json into --workdir.

``--dry-run`` synthesizes a torch-layout teacher state dict at micro
geometry + synthetic CIFAR-10 and runs the identical code path, proving the
gate executes before real artifacts exist. The real path runs once someone
puts real CIFAR-10 and a real teacher on disk.

    python -m qat_vit_tpu_torch.scripts.validate_real --workdir /tmp/real \
        --data-dir /path/with/cifar-10-batches-py \
        --teacher-ckpt /path/to/pytorch_model.bin [--owlv2-ckpt ...] [--full-loop]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil

import numpy as np
import torch

from qat_vit_tpu_torch.data.cifar10 import load_cifar10, synthetic_cifar10
from qat_vit_tpu_torch.data.pipeline import ArrayLoader
from qat_vit_tpu_torch.evaluation.evaluator import evaluate_model
from qat_vit_tpu_torch.models.jax_params import load_jax_variables, state_dict_to_params
from qat_vit_tpu_torch.models.owlv2_detect import create_detector, owlv2_detection_to_params
from qat_vit_tpu_torch.models.registry import create_architecture, create_model
from qat_vit_tpu_torch.models.torch_convert import (
    load_torch_state_dict,
    params_to_timm_vit,
    timm_vit_to_params,
)
from qat_vit_tpu_torch.models.vit import VisionTransformer
from qat_vit_tpu_torch.train.trainer import entry_device
from qat_vit_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

logger = logging.getLogger("validate_real")


def _teacher_cfg(micro: bool):
    return create_architecture("vit_micro_test" if micro
                               else "vit_base_patch16_224_teacher").cfg


def validate_teacher(ckpt: str, micro: bool, data, batch_size: int, device="cuda") -> dict:
    """Convert (strict) + full-test-set fp32 eval -> the anchor row."""
    cfg = _teacher_cfg(micro)
    if ckpt.endswith((".pth", ".bin", ".pt")):
        state = load_torch_state_dict(ckpt)
        # strict: unconsumed / missing checkpoint keys fail loudly — the
        # proof that the real checkpoint's layout maps completely
        params = timm_vit_to_params(state, cfg, strict=True)
        converted = True
    else:
        params = load_checkpoint(ckpt)
        if "params" in params:
            params = params["params"]
        converted = False
    model = load_jax_variables(VisionTransformer(cfg), params).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    loader = ArrayLoader(
        data["test_images"], data["test_labels"], batch_size=batch_size,
        shuffle=False, drop_last=False,
    )
    top1 = evaluate_model(lambda x: model(x, observe=False), loader, cfg.image_size, device)
    return {
        "teacher_ckpt": ckpt,
        "converted_from_torch_strict": converted,
        "teacher_params": n_params,
        "teacher_fp32_top1": top1,
    }


def validate_owlv2(ckpt: str, micro: bool, device="cuda") -> dict:
    """HF Owlv2ForObjectDetection state dict -> detector forward smoke."""
    state = load_torch_state_dict(ckpt)
    geo = (dict(image_size=32, patch_size=8, embed_dim=64, depth=2,
                num_heads=2, mlp_ratio=2.0) if micro else {})
    det, cfg = create_detector(pruned=False, **geo)
    params = owlv2_detection_to_params(state, cfg)
    det = load_jax_variables(det, params).to(device)
    x = torch.zeros((1, cfg.image_size, cfg.image_size, 3), device=device)
    q = torch.zeros((1, 2, 512), device=device)
    with torch.no_grad():
        out = det(x, q, observe=False)
    finite = all(
        bool(torch.isfinite(v).all()) for v in
        (out["pred_boxes"], out["logits"], out["objectness_logits"])
    )
    return {
        "owlv2_ckpt": ckpt,
        "owlv2_params": sum(p.numel() for p in det.parameters()),
        "owlv2_forward_finite": finite,
    }


def stage_full_loop(workdir: str, data, teacher_params_path: str) -> None:
    """Lay the real data + teacher into the accuracy loop's layout so its
    idempotent phases consume them instead of generating synthetic ones."""
    ddir = os.path.join(workdir, "data")
    os.makedirs(ddir, exist_ok=True)
    npz = os.path.join(ddir, "cifar10.npz")
    if not os.path.isfile(npz):
        np.savez_compressed(npz + ".tmp.npz", **data)
        os.replace(npz + ".tmp.npz", npz)
    tdir = os.path.join(workdir, "teacher")
    os.makedirs(tdir, exist_ok=True)
    dst = os.path.join(tdir, "teacher.msgpack")
    if not os.path.isfile(dst):
        shutil.copyfile(teacher_params_path, dst)
        sidecar = teacher_params_path + ".json"
        if os.path.isfile(sidecar):
            shutil.copyfile(sidecar, dst + ".json")


def main(argv=None, device="cuda") -> dict:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--teacher-ckpt", default="",
                   help=".pth/.bin (HF/timm torch layout, converted strictly)"
                        " or a converted .msgpack")
    p.add_argument("--owlv2-ckpt", default="",
                   help="optional HF Owlv2ForObjectDetection state dict")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--allow-synthetic", action="store_true",
                   help="proceed on the synthetic CIFAR-10 fallback")
    p.add_argument("--full-loop", action="store_true",
                   help="stage data+teacher and run the full accuracy loop "
                        "(search -> KD+QAT -> convert -> int8)")
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--final-epochs", type=int, default=10)
    p.add_argument("--dry-run", action="store_true",
                   help="synthesize micro artifacts and run the same path "
                        "(no network, proves the gate executes)")
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)

    report: dict = {}
    micro = args.dry_run
    if args.dry_run:
        # synthesize the real-artifact shapes: a torch-layout state dict at
        # micro geometry (saved with torch, as a real download would be)
        data = synthetic_cifar10(n_train=64, n_test=64, seed=0)
        if not args.teacher_ckpt:
            cfg = _teacher_cfg(micro=True)
            module = create_model("vit_micro_test",
                                  generator=torch.Generator().manual_seed(0)).module
            state = params_to_timm_vit(state_dict_to_params(module.state_dict()), cfg)
            args.teacher_ckpt = os.path.join(args.workdir, "teacher_dry.pth")
            torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in state.items()}, args.teacher_ckpt)
        args.batch_size = min(args.batch_size, 64)
        report["data_source"] = "synthetic (dry-run)"
    else:
        data, source = load_cifar10(args.data_dir)
        report["data_source"] = source
        if source == "synthetic" and not args.allow_synthetic:
            p.error(
                f"--data-dir {args.data_dir!r} holds no real CIFAR-10 "
                "(cifar-10-batches-py/, -bin/, .tar.gz or .npz); the "
                "real-data anchor needs the real test set. Pass "
                "--allow-synthetic to proceed anyway."
            )

    if not args.teacher_ckpt:
        p.error("--teacher-ckpt is required (HF pytorch_model.bin, a timm "
                "state dict, or a converted .msgpack); see the module docstring")
    device = entry_device(device)
    report.update(validate_teacher(
        args.teacher_ckpt, micro, data, args.batch_size, device=device))

    if args.owlv2_ckpt:
        report.update(validate_owlv2(args.owlv2_ckpt, micro, device=device))

    if args.full_loop and not args.dry_run:
        # persist the converted teacher once, then hand off to the loop
        from qat_vit_tpu_torch.scripts import accuracy_loop

        tpath = os.path.join(args.workdir, "teacher_converted.msgpack")
        if args.teacher_ckpt.endswith((".pth", ".bin", ".pt")):
            params = timm_vit_to_params(
                load_torch_state_dict(args.teacher_ckpt),
                _teacher_cfg(False), strict=True)
            save_checkpoint(tpath, {"params": params},
                            {"source": args.teacher_ckpt})
        else:
            tpath = args.teacher_ckpt
        stage_full_loop(args.workdir, data, tpath)
        accuracy_loop.main(["--workdir", args.workdir, "--trials", str(args.trials),
                            "--final-epochs", str(args.final_epochs)], device=device)
        lr = os.path.join(args.workdir, "REPORT.json")
        if os.path.isfile(lr):
            with open(lr) as f:
                report["full_loop"] = json.load(f)

    # ---- emit the anchor table ----
    jpath = os.path.join(args.workdir, "REPORT_real.json")
    with open(jpath, "w") as f:
        json.dump(report, f, indent=2, default=str)
    lines = [
        "# Real-data validation anchor",
        "",
        "| item | value |",
        "|---|---|",
    ]
    for k, v in report.items():
        if k == "full_loop":
            continue
        lines.append(f"| {k} | {v} |")
    if "full_loop" in report:
        lines += ["", "Full accuracy loop: see REPORT.md in this workdir."]
    mpath = os.path.join(args.workdir, "REPORT_real.md")
    with open(mpath, "w") as f:
        f.write("\n".join(lines) + "\n")
    logger.info("wrote %s and %s", mpath, jpath)
    print(json.dumps(report, default=str))
    return report


if __name__ == "__main__":  # pragma: no cover
    main()
