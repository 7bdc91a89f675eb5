"""Standalone evaluation: test-set top-1 for any checkpoint kind (port of
``qat_vit_tpu/evaluation/evaluator.py``, the reference's
``src/evaluation/evaluator.py`` made to work).

Three model kinds, as the JAX package evaluates them:

- float params (``quant=None``), in f32 without fast_math: the einsum
  attention, as JAX runs it there;
- fake-quant QAT checkpoints (params + ``quant_stats``, ``best_qat.msgpack``,
  ``qat_wrapper=True``), likewise in f32;
- true-int8 exports (``best_converted.msgpack``, ``int8=True``) through the
  serving forward: ``serving="exact"`` (the f32 parity path, its GEMMs and
  attention in plain PyTorch, as JAX keeps ``use_pallas`` off there) or
  ``serving="preset"`` (``serve.int8_vit.serving_preset``: on the card the
  hand-written int8 kernels; off the card the exact path).

Checkpoints are read by the port's codec (either package's files); an
export goes to the device through ``export_to_device``, which packs the
weights the int8 kernels read. Every entry point runs on the card unless the
caller passes ``device="cpu"``. :func:`main` is the CLI, ``python -m
qat_vit_tpu_torch.evaluation.evaluator``, with the JAX package's flags; it
prints ``top1_acc=...``.
"""

from __future__ import annotations

import argparse
import logging
from typing import Callable, Optional

import numpy as np
import torch

from qat_vit_tpu_torch.data.cifar10 import load_cifar10
from qat_vit_tpu_torch.data.pipeline import ArrayLoader, preprocess_fn
from qat_vit_tpu_torch.models.jax_params import (
    buffers_to_quant_stats,
    export_from_numpy,
    params_to_state_dict,
    quant_stats_to_buffers,
    state_dict_to_params,
)
from qat_vit_tpu_torch.models.registry import create_architecture, create_model
from qat_vit_tpu_torch.quant.qconfig import default_qat_qconfig
from qat_vit_tpu_torch.serve.int8_vit import export_to_device, make_int8_forward, serving_preset
from qat_vit_tpu_torch.train.losses import top1_correct
from qat_vit_tpu_torch.train.trainer import entry_device
from qat_vit_tpu_torch.utils.checkpoint import load_checkpoint, tolerant_merge

logger = logging.getLogger(__name__)


def build_cifar10_loader(data_dir: str = "./data", batch_size: int = 512,
                         limit: int = 0) -> ArrayLoader:
    """Test-set loader (reference build_cifar10_loaders, evaluator.py:21-41):
    the first ``limit`` batches' images when ``limit`` is set, in order, the
    last batch short."""
    data, source = load_cifar10(data_dir)
    logger.info("CIFAR-10 source: %s", source)
    images, labels = data["test_images"], data["test_labels"]
    if limit:
        images, labels = images[: limit * batch_size], labels[: limit * batch_size]
    return ArrayLoader(images, labels, batch_size=batch_size, shuffle=False, drop_last=False)


def evaluate_model(apply_fn: Callable[[torch.Tensor], torch.Tensor], loader: ArrayLoader,
                   image_size: int, device="cuda") -> float:
    """Top-1 of ``apply_fn`` (normalized NHWC images on ``device`` →
    logits) over ``loader`` (reference evaluate_model, evaluator.py:44-56).
    A short last batch is padded to the batch size with zero images and
    label −1, so every call sees one shape and only its real rows count; the
    counts stay on the device until the end."""
    device = torch.device(device)
    prep = preprocess_fn(image_size)
    bs = loader.batch_size
    correct = torch.zeros((), dtype=torch.int64, device=device)
    total = 0
    with torch.no_grad():
        for batch in loader:
            img, lab = batch["image"], batch["label"].astype(np.int64)
            n = len(lab)
            if n < bs:
                img = np.concatenate([img, np.zeros((bs - n,) + img.shape[1:], img.dtype)])
                lab = np.concatenate([lab, np.full(bs - n, -1, np.int64)])
            x = prep(torch.from_numpy(np.ascontiguousarray(img)).to(device))
            correct += top1_correct(apply_fn(x), torch.from_numpy(lab).to(device))
            total += n
    return int(correct) / max(total, 1)


def _load_module_state(module: torch.nn.Module, ckpt_path: str) -> None:
    """The checkpoint's ``params`` / ``quant_stats`` over the module's own
    (tolerant: leaves the file lacks keep the module's values, extra ones
    are ignored), as the JAX evaluator merges a file into its init tree."""
    sd = module.state_dict()
    template = {"params": state_dict_to_params(sd), "quant_stats": buffers_to_quant_stats(sd)}
    merged, _, _ = tolerant_merge(template, load_checkpoint(ckpt_path))
    new = params_to_state_dict(merged["params"])
    new.update(quant_stats_to_buffers(merged["quant_stats"]))
    module.load_state_dict(new, strict=True)


def evaluate_checkpoint(
    model_name: str,
    ckpt_path: Optional[str] = None,
    *,
    qat_wrapper: bool = False,
    int8: bool = False,
    data_dir: str = "./data",
    batch_size: int = 512,
    limit_batches: int = 0,
    num_classes: int = 10,
    qat_backend: str = "qnnpack",
    serving: str = "exact",
    image_size: int = 0,
    device="cuda",
) -> float:
    """Create → load → evaluate (reference evaluate_checkpoint,
    evaluator.py:59-101), on ``device`` (a CUDA device must be present).

    ``qat_backend`` must be the backend the checkpoint was trained with
    (``effective_hparams.yaml`` / ``best_params.yaml`` record it): qnnpack
    and fbgemm quantize activations to different ranges. ``serving`` picks
    the int8 forward (``"exact"`` or ``"preset"``). ``image_size`` overrides
    the registry's resolution (0 keeps it), for checkpoints trained at
    another ``--image-size``. Float and fake-quant weights start from the
    registry's random init (seed 0) and take every leaf the file holds."""
    device = entry_device(device)
    quantized = qat_wrapper or int8
    kw = dict(num_classes=num_classes, qat_wrapper=quantized,
              **({"quant": default_qat_qconfig(qat_backend)} if quantized else {}),
              **({"image_size": image_size} if image_size else {}))
    loader = build_cifar10_loader(data_dir, batch_size, limit_batches)

    if int8:
        if ckpt_path is None:
            raise ValueError("int8 evaluation requires --ckpt (best_converted)")
        if serving not in ("exact", "preset"):
            raise ValueError(f"serving must be 'exact' or 'preset', got {serving!r}")
        cfg = create_architecture(model_name, **kw).cfg
        qp = export_to_device(export_from_numpy(load_checkpoint(ckpt_path)), device)
        fwd = make_int8_forward(cfg, **(serving_preset(cfg, device) if serving == "preset"
                                        else {}))
        return evaluate_model(lambda x: fwd(qp, x), loader, cfg.image_size, device)

    bundle = create_model(model_name, generator=torch.Generator().manual_seed(0), **kw)
    module = bundle.module
    if ckpt_path is not None:
        _load_module_state(module, ckpt_path)
    module = module.to(device)
    return evaluate_model(lambda x: module(x, observe=False), loader, bundle.cfg.image_size,
                          device)


def main(argv=None, device="cuda") -> None:
    """The CLI the reference intended (its argparse is cut off mid-string,
    evaluator.py:104-109)."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="evaluate a checkpoint on CIFAR-10")
    p.add_argument("--model", default="vit_small_patch16_224_student")
    p.add_argument("--ckpt", default=None, help="best_qat/best_converted.msgpack")
    p.add_argument("--qat-wrapper", action="store_true",
                   help="checkpoint carries quant_stats (best_qat)")
    p.add_argument("--int8", action="store_true",
                   help="checkpoint is a true-int8 export (best_converted)")
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--limit-batches", type=int, default=0)
    p.add_argument("--qat-backend", default="qnnpack", choices=("qnnpack", "fbgemm"),
                   help="backend the checkpoint was trained with (see effective_hparams.yaml)")
    p.add_argument("--serving", default="exact", choices=("exact", "preset"),
                   help="int8 forward: exact f32 parity path or the serving preset's kernels "
                        "(--int8 only)")
    p.add_argument("--image-size", type=int, default=0,
                   help="override the model's native resolution (match the trainer's "
                        "--image-size; 0 = native)")
    args = p.parse_args(argv)
    acc = evaluate_checkpoint(
        args.model, args.ckpt, qat_wrapper=args.qat_wrapper, int8=args.int8,
        data_dir=args.data_dir, batch_size=args.batch_size, limit_batches=args.limit_batches,
        qat_backend=args.qat_backend, serving=args.serving, image_size=args.image_size,
        device=device,
    )
    print(f"top1_acc={acc:.4f}")


if __name__ == "__main__":  # pragma: no cover
    main()
