"""Hyperparameter search driver (port of ``qat_vit_tpu/search/driver.py``,
the reference's ``optuna_search`` rebuilt).

As the JAX driver: a ``SearchConfig`` dataclass (reference
src/training/optuna_search.py:33-55), data and teacher built once
(:58-80, :118-120), TPE + median pruning (:127-129), the reference's search
space (:132-137: lr ∈ [5e-5, 3e-4] log, wd ∈ [1e-6, 1e-2] log,
label_smoothing ∈ [0, 0.2], kd_temp ∈ [1.5, 6], kd_alpha ∈ [0.2, 0.9],
qat_start_epoch ∈ [0, epochs − 2]), limited train / eval batch budgets
(:209, :89), per-epoch report and prune (:250, :261-263), a ``trial_NNNN``
tracked run per trial (:156-173), ``best_params.yaml`` with epochs /
batch_size / qat_backend appended (:273-280) and a final
``optuna_best_summary`` run (:282-285). ``task="detection"`` searches the
detection-KD objective over the OWLv2 detectors.

Trial reuse: the teacher is built once and, after the first trial has
frozen it on the device (bf16), handed to every later trainer
(``teacher_params``), with the first trainer's step functions (``steps``)
and its teacher-logit cache (``teacher_logits``; the detection teacher's
output cache, ``teacher_cache``) shared by reference, so rows one trial
fills serve every later trial. The student is an architecture (built on the
``meta`` device): trial ``k`` draws a fresh one from seed ``seed + k``.
A trial's trainer is dropped when the trial ends.

A crashed trial is recorded as ``FAILED`` with its traceback as a tag, and
the study goes on (the reference's record-and-continue). optuna is imported
when installed and used (the reference's multivariate TPE), the in-repo
sampler (``search/tpe.py``) otherwise. ``best_params.yaml`` is written by
``train.config.dump_flat_yaml``: the bytes ``yaml.safe_dump(sort_keys=True)``
writes, without ``pyyaml``.

:func:`main` is the CLI, ``python -m qat_vit_tpu_torch.search.driver``,
with the JAX package's flags (one per ``SearchConfig`` field); it runs on
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import logging
import os
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

from qat_vit_tpu_torch.data.cifar10 import load_cifar10
from qat_vit_tpu_torch.models.registry import create_model, create_student, create_teacher
from qat_vit_tpu_torch.search import tpe as _tpe
from qat_vit_tpu_torch.tracking import make_tracker
from qat_vit_tpu_torch.train.config import DEFAULT_HPARAMS, dump_flat_yaml
from qat_vit_tpu_torch.train.trainer import KDQATTrainer, entry_device

logger = logging.getLogger(__name__)


def _has_optuna() -> bool:
    try:
        return importlib.util.find_spec("optuna") is not None
    except (ImportError, ValueError):
        return False


# optuna is found here and imported only by a search that uses it
HAS_OPTUNA = _has_optuna()


@dataclasses.dataclass
class SearchConfig:
    """Reference SearchConfig (optuna_search.py:33-55), the JAX package's
    fields and defaults."""

    trials: int = 30
    epochs: int = 10
    batch_size: int = 64  # the recorded study ran at 64 (mlflow.db)
    eval_batch_size: int = 64
    limit_train_batches: int = 200  # "epoch" = 200 train batches (ref :209)
    limit_eval_batches: int = 50  # + 50 eval batches (ref :89)
    output_dir: str = "./qat_search"
    mlflow_uri: str = "sqlite:///mlflow.db"
    experiment: str = "clue-vit-qat-optuna"  # reference experiment name
    seed: int = 0
    data_dir: str = "./data"
    image_size: int = 224
    num_classes: int = 10
    qat_backend: str = "qnnpack"
    student_family: str = "vit"
    model_parallel: int = 1
    micro: bool = False  # micro models for CI/smoke
    # pretrained teacher weights; "" keeps the random-init teacher
    teacher_ckpt: str = ""
    # joint (optuna-style multivariate) sampling for the in-repo sampler
    tpe_multivariate: bool = False
    # "classification" (the reference's task) or "detection" (the OWLv2
    # detectors under the detection-KD objective)
    task: str = "classification"


def suggest_hparams(trial, cfg: SearchConfig) -> Dict[str, Any]:
    """The reference's search space (optuna_search.py:132-137)."""
    return {
        "lr": trial.suggest_float("lr", 5e-5, 3e-4, log=True),
        "weight_decay": trial.suggest_float("weight_decay", 1e-6, 1e-2, log=True),
        "label_smoothing": trial.suggest_float("label_smoothing", 0.0, 0.2),
        "kd_temperature": trial.suggest_float("kd_temperature", 1.5, 6.0),
        "kd_alpha": trial.suggest_float("kd_alpha", 0.2, 0.9),
        "qat_start_epoch": trial.suggest_int("qat_start_epoch", 0, max(cfg.epochs - 2, 0)),
    }


def suggest_detect_hparams(trial, cfg: SearchConfig) -> Dict[str, Any]:
    """The detection-KD search space: the reference's lr / wd / T /
    qat_start ranges and the detection loss weights around their trainer
    defaults (1.0 / 0.25) in place of label_smoothing / kd_alpha."""
    return {
        "lr": trial.suggest_float("lr", 5e-5, 3e-4, log=True),
        "weight_decay": trial.suggest_float("weight_decay", 1e-6, 1e-2, log=True),
        "kd_temperature": trial.suggest_float("kd_temperature", 1.5, 6.0),
        "det_box_weight": trial.suggest_float("det_box_weight", 0.2, 5.0, log=True),
        "det_obj_weight": trial.suggest_float("det_obj_weight", 0.05, 1.0, log=True),
        "qat_start_epoch": trial.suggest_int("qat_start_epoch", 0, max(cfg.epochs - 2, 0)),
    }


_PARAM_KEYS = ("lr", "weight_decay", "label_smoothing", "kd_temperature", "kd_alpha",
               "qat_start_epoch")
_DETECT_PARAM_KEYS = ("lr", "weight_decay", "kd_temperature", "det_box_weight",
                      "det_obj_weight", "qat_start_epoch")


def _models(cfg: SearchConfig):
    """(teacher, student architecture, image size, text dim): the teacher
    with weights drawn from ``cfg.seed`` (the first trial loads
    ``teacher_ckpt`` over them), the student on the ``meta`` device."""
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.task == "detection":
        geo = (dict(image_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2,
                    mlp_ratio=2.0) if cfg.micro else dict(image_size=cfg.image_size))
        text_dim = 64 if cfg.micro else int(DEFAULT_HPARAMS["text_dim"])
        teacher = create_model("owlv2_base_detector", text_dim=text_dim, dtype=torch.bfloat16,
                               generator=gen, **geo)
        with torch.device("meta"):
            student = create_model("owlv2_pruned_detector", text_dim=text_dim, **geo)
        return teacher, student, geo["image_size"], text_dim
    if cfg.micro:
        teacher = create_model("vit_micro_test", generator=gen)
        with torch.device("meta"):
            student = create_model("vit_micro_test")
        return teacher, student, teacher.cfg.image_size, None
    teacher = create_teacher(cfg.student_family, num_classes=cfg.num_classes,
                             image_size=cfg.image_size, dtype=torch.bfloat16, generator=gen)
    with torch.device("meta"):
        student = create_student(cfg.student_family, num_classes=cfg.num_classes,
                                 image_size=cfg.image_size)
    return teacher, student, cfg.image_size, None


def run_optuna_search(
    cfg: SearchConfig,
    data: Optional[Dict[str, np.ndarray]] = None,
    prefer_optuna: bool = True,
    device="cuda",
) -> Dict[str, Any]:
    """The search on ``device`` (a CUDA device must be present; pass
    ``device="cpu"`` for the CPU): returns ``best_params`` (what
    ``best_params.yaml`` holds), ``best_value``, ``best_params_path`` and
    the ``study``."""
    device = entry_device(device)
    os.makedirs(cfg.output_dir, exist_ok=True)
    tracker = make_tracker(cfg.mlflow_uri, cfg.experiment)

    # data + teacher built ONCE (ref :58-80, :118-120)
    if data is None:
        data, source = load_cifar10(cfg.data_dir)
        logger.info("CIFAR-10 source: %s", source)

    detection = cfg.task == "detection"
    teacher, student, image_size, text_dim = _models(cfg)
    base_hp = dict(DEFAULT_HPARAMS)
    base_hp.update(
        epochs=cfg.epochs, batch_size=cfg.batch_size, eval_batch_size=cfg.eval_batch_size,
        image_size=image_size, num_classes=cfg.num_classes, qat_backend=cfg.qat_backend,
        model_parallel=cfg.model_parallel, seed=cfg.seed, teacher_ckpt=cfg.teacher_ckpt,
    )
    if detection:
        # one query set across ALL trials: the shared teacher-output cache
        # is only valid if every trial distils against the same queries
        base_hp.update(task="detection", query_seed=cfg.seed, text_dim=text_dim)
        if cfg.micro:
            base_hp["num_queries"] = 3
    param_keys = _DETECT_PARAM_KEYS if detection else _PARAM_KEYS
    state = {"teacher_params": None, "shared_steps": None, "teacher_logits": None,
             "teacher_cache": None}

    use_optuna = HAS_OPTUNA and prefer_optuna
    if use_optuna:  # pragma: no cover - where optuna is installed
        import optuna

        pruned_exc = optuna.TrialPruned
    else:
        pruned_exc = _tpe.TrialPruned

    def make_trainer(hp, trial):
        shared = dict(data=data, student=student, teacher=teacher,
                      teacher_params=state["teacher_params"], steps=state["shared_steps"],
                      seed=cfg.seed + trial.number)  # a fresh student per trial (ref :143)
        if detection:
            from qat_vit_tpu_torch.train.detect_trainer import DetectKDTrainer

            return DetectKDTrainer(hp, device=device, teacher_cache=state["teacher_cache"],
                                   **shared)
        return KDQATTrainer(hp, device=device, teacher_logits=state["teacher_logits"], **shared)

    def train_trial(trial, hp, run) -> float:
        trainer = make_trainer(hp, trial)
        if state["teacher_params"] is None:
            state["teacher_params"] = trainer.teacher_params
        if state["shared_steps"] is None:
            state["shared_steps"] = trainer.shared_steps()
        best_acc = acc = 0.0
        for epoch in range(cfg.epochs):
            if epoch >= int(hp["qat_start_epoch"]):
                trainer.enable_qat()  # ref :179-189
            tm = trainer.train_epoch(epoch, limit_batches=cfg.limit_train_batches)
            if detection and state["teacher_cache"] is None:
                # the cache arrays BY REFERENCE: lazy fills serve every later trial
                state["teacher_cache"] = trainer.teacher_cache()
            if (not detection and state["teacher_logits"] is None
                    and trainer._teacher_logits is not None):
                # the (logits, filled-rows mask) pair BY REFERENCE
                state["teacher_logits"] = (trainer._teacher_logits, trainer._teacher_mask)
            if detection:
                ev = trainer.evaluate(limit_batches=cfg.limit_eval_batches)
                acc = ev["teacher_agreement"]
                best_acc = max(best_acc, acc)
                run.log_metrics({
                    "train_loss": tm.get("train_loss", 0.0),
                    "train_loss_kd": tm.get("train_loss_kd", 0.0),
                    "train_loss_box": tm.get("train_loss_box", 0.0),
                    "train_loss_obj": tm.get("train_loss_obj", 0.0),
                    "box_err_limited": ev["box_err"],
                    "val_agreement_limited": acc,
                    "best_val_agreement_limited": best_acc,
                    "qat_enabled": float(trainer.qat_enabled),
                }, step=epoch)
            else:
                acc = trainer.evaluate(limit_batches=cfg.limit_eval_batches)
                best_acc = max(best_acc, acc)
                run.log_metrics({
                    "train_loss": tm.get("train_loss", 0.0),
                    "train_loss_ce": tm.get("train_loss_ce", 0.0),
                    "train_loss_kd": tm.get("train_loss_kd", 0.0),
                    "val_acc_limited": acc,
                    "best_val_acc_limited": best_acc,
                    "qat_enabled": float(trainer.qat_enabled),
                    "amp_enabled": float(not trainer.qat_enabled and hp["amp"]),
                }, step=epoch)  # metric names as ref :253-259
            trial.report(acc, epoch)  # ref :250
            if trial.should_prune():  # ref :261-263
                run.set_tag("optuna_state", "PRUNED")
                run.end("FINISHED")
                raise pruned_exc()
        return acc  # the last epoch's limited val metric (the reference's objective)

    def objective(trial) -> float:
        hp = dict(base_hp)
        hp.update(suggest_detect_hparams(trial, cfg) if detection else suggest_hparams(trial, cfg))
        run = tracker.start_run(f"trial_{trial.number:04d}")  # ref :156
        run.log_params({**{k: hp[k] for k in param_keys}, "batch_size": cfg.batch_size,
                        "epochs": cfg.epochs, "qat_backend": cfg.qat_backend})
        try:
            acc = train_trial(trial, hp, run)
        except pruned_exc:
            raise
        except Exception:
            # record and continue, with the traceback as a tag so that a
            # failure is diagnosable
            logger.exception("trial %d FAILED", trial.number)
            run.set_tag("optuna_state", "FAILED")
            run.set_tag("failure_traceback", traceback.format_exc()[-4000:])
            run.end("FAILED")
            raise
        finally:
            gc.collect()  # the trial's trainer, optimizer and students go
        run.set_tag("optuna_state", "COMPLETE")
        run.end("FINISHED")
        return acc

    if use_optuna:  # pragma: no cover - where optuna is installed
        sampler = optuna.samplers.TPESampler(multivariate=True, seed=cfg.seed)
        pruner = optuna.pruners.MedianPruner(n_startup_trials=5, n_warmup_steps=1)
        study = optuna.create_study(direction="maximize", sampler=sampler, pruner=pruner)
    else:
        study = _tpe.create_study(direction="maximize", seed=cfg.seed, n_startup_trials=5,
                                  n_warmup_steps=1, multivariate=cfg.tpe_multivariate)
    # a crashed trial must not end the study (the reference's study records
    # FAILED runs beside finished ones)
    study.optimize(objective, n_trials=cfg.trials, catch=(Exception,))
    best_params, best_value = dict(study.best_params), study.best_value

    # best_params.yaml with the trainer-consumable extras (ref :273-280); the
    # temperature under both spellings: kd_temperature and the reference's kd_temp
    out = dict(best_params)
    if "kd_temperature" in out:
        out["kd_temp"] = out["kd_temperature"]
    out["epochs"] = cfg.epochs
    out["batch_size"] = cfg.batch_size
    out["qat_backend"] = cfg.qat_backend
    best_path = os.path.join(cfg.output_dir, "best_params.yaml")
    with open(best_path, "w") as f:
        f.write(dump_flat_yaml(out))

    with tracker.start_run("optuna_best_summary") as run:  # ref :282-285
        run.log_params(out)
        run.log_metric("best_value", float(best_value))

    logger.info("search done: best_value=%.4f -> %s", best_value, best_path)
    return {"best_params": out, "best_value": float(best_value),
            "best_params_path": best_path, "study": study}


def main(argv=None, device="cuda") -> None:
    """The search CLI: one flag per ``SearchConfig`` field, as the JAX
    package's."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="QAT hyperparameter search (PyTorch + CUDA)")
    for f in dataclasses.fields(SearchConfig):
        flag = "--" + f.name.replace("_", "-")
        if f.type is bool or isinstance(f.default, bool):
            p.add_argument(flag, action="store_true", default=f.default)
        else:
            p.add_argument(flag, type=type(f.default), default=f.default)
    args = p.parse_args(argv)
    cfg = SearchConfig(**{f.name: getattr(args, f.name) for f in dataclasses.fields(SearchConfig)})
    run_optuna_search(cfg, device=device)


if __name__ == "__main__":  # pragma: no cover
    main()
