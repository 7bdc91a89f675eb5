"""Pretrain a teacher from scratch for the full-scale accuracy loop (port of
``scripts/pretrain_teacher.py``).

The reference downloads a CIFAR-10-finetuned ViT-B teacher from HuggingFace
(reference src/models/model_registry.py:186-189), which needs a network.
This script produces the equivalent artifact locally: a trained teacher
checkpoint (``{output_dir}/teacher.msgpack``, the JAX layout either package
reads) whose path feeds the trainer's ``teacher_ckpt`` config key. It reuses
the ``KDQATTrainer`` engine with ``kd_alpha=0`` (pure CE: the KD term
vanishes) and QAT never enabled.

    python -m qat_vit_tpu_torch.scripts.pretrain_teacher --data-dir DATA \
        --output-dir OUT [--arch vit_base_patch16_224_teacher] [--epochs 10] [--lr 3e-4]
"""

from __future__ import annotations

import argparse
import logging
import os
import time

from qat_vit_tpu_torch.models.jax_params import state_dict_to_params
from qat_vit_tpu_torch.models.registry import create_model
from qat_vit_tpu_torch.train.config import DEFAULT_HPARAMS
from qat_vit_tpu_torch.train.trainer import KDQATTrainer, entry_device
from qat_vit_tpu_torch.utils.checkpoint import BestCheckpointer

logger = logging.getLogger("pretrain_teacher")


def main(argv=None, device="cuda"):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--output-dir", default="./teacher_pretrain")
    p.add_argument("--arch", default="vit_base_patch16_224_teacher")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--eval-batch-size", type=int, default=512)
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit-train-batches", type=int, default=0)
    p.add_argument("--limit-eval-batches", type=int, default=0)
    args = p.parse_args(argv)
    device = entry_device(device)

    hp = dict(DEFAULT_HPARAMS)
    hp.update(
        lr=args.lr,
        weight_decay=args.weight_decay,
        label_smoothing=args.label_smoothing,
        kd_alpha=0.0,  # pure CE: the KL term is multiplied out
        qat_start_epoch=10**9,  # QAT never enabled
        epochs=args.epochs,
        batch_size=args.batch_size,
        eval_batch_size=args.eval_batch_size,
        image_size=args.image_size,
        data_dir=args.data_dir,
        output_dir=args.output_dir,
        seed=args.seed,
        save_resume_state=False,
        # a throwaway micro "teacher" satisfies the KD plumbing; with
        # kd_alpha=0 its (cached, once) logits never influence the loss
        cache_teacher_logits=True,
    )

    os.makedirs(args.output_dir, exist_ok=True)
    model = create_model(args.arch, qat_wrapper=False, image_size=args.image_size)
    dummy_teacher = create_model("vit_micro_test", qat_wrapper=False,
                                 image_size=args.image_size)
    trainer = KDQATTrainer(hp, device=device, student=model, teacher=dummy_teacher)
    best = BestCheckpointer(args.output_dir, "teacher")
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        tm = trainer.train_epoch(epoch, limit_batches=args.limit_train_batches)
        acc = trainer.evaluate(limit_batches=args.limit_eval_batches)
        # the student's weights in the JAX layout (the files either package reads), on the host
        params = state_dict_to_params(trainer.full_state_dict(trainer.state.module))
        improved, path = best.maybe_save(
            acc,
            {"params": params},
            {"epoch": epoch, "acc": acc, "arch": args.arch,
             "kind": "teacher-pretrain"},
        )
        logger.info(
            "epoch %d/%d loss %.4f top1 %.4f (%.0f img/s, %.0fs)%s",
            epoch + 1, args.epochs, tm.get("train_loss", 0.0), acc,
            tm["imgs_per_sec"], time.perf_counter() - t0,
            " [saved]" if improved else "",
        )
    logger.info("best teacher top-1 %.4f at %s", best.best_metric,
                best.best_path)
    print(best.best_path)


if __name__ == "__main__":  # pragma: no cover
    main()
