"""Detection KD + QAT trainer, one device per process: distil a teacher
OWLv2 detector into a pruned, QAT-armed student detector (port of
``qat_vit_tpu/train/detect_trainer.py``).

The classification trainer's phase machine (float phase → QAT switch with
fresh observers and fresh AdamW moments at LR × ``qat_lr_scale`` → convert)
over the detection KD objective (``train/detect_steps.py``). There is no
labelled detection data in the pipeline: the frozen teacher is the
supervision, evaluation is teacher-relative (mean |Δbox|, top-box
agreement), and the query embeddings are fixed per run (unit-norm, from a
``torch.Generator`` seeded by ``query_seed``, else ``seed``).

Configs, as the JAX trainer builds them under its defaults: the float
student in bf16 with fast_math, the QAT student in bf16 (``qat_amp``) with
fast_math; at 768 px every attention of the student runs through the
long-sequence kernels (K5a forward, K5b backward, ``ops/long_attention.py``).
The teacher is bf16 with the einsum attention and an f32 softmax; its
outputs are cached per image in host RAM (P·(Q+5) f32 per image, ~83 KB at
768 px with 4 queries), filled in eval-batch chunks, eagerly or, for a
limited-batch run, as batches are visited.

The teacher's weights come from a file with ``teacher_ckpt`` (a msgpack of
the JAX package's detector tree, its ``"params"`` when it holds one, as
``models/owlv2_detect.owlv2_detection_to_params`` converts an HF
checkpoint); ``student=`` / ``teacher=`` take built models in place of the
registry's. ``observer_interval``, ``observer_stride`` and resume work as in
classification (``train/trainer.py``, whose resume code this trainer
shares); :func:`detect_train_main` is the whole run behind the CLI's
``--task detection``. Data parallelism as in classification: under
``torchrun`` each rank trains its shard ``rank::world`` at ``batch_size``
per process through a DDP replica, the activation observers reduce over
the ranks and the epoch's metrics are averaged; the teacher-relative eval
runs over the whole set on every rank, as the JAX trainer's
``_padded_eval_batches`` (which has no rank shard). A model axis
(``model_parallel`` > 1) raises JAX's ``ValueError``: detection training
runs on pure data-parallel meshes only, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from qat_vit_tpu_torch.data.cifar10 import load_cifar10
from qat_vit_tpu_torch.data.pipeline import ArrayLoader, preprocess_fn
from qat_vit_tpu_torch.models.jax_params import (
    buffers_to_quant_stats,
    load_jax_variables,
    state_dict_to_params,
)
from qat_vit_tpu_torch.models.owlv2_detect import Owlv2Detector
from qat_vit_tpu_torch.models.registry import ModelBundle, create_model, with_weights
from qat_vit_tpu_torch.parallel import barrier, get_dist_info
from qat_vit_tpu_torch.serve.int8_detect import convert_detector, make_int8_detect_forward
from qat_vit_tpu_torch.serve.int8_vit import export_to_device
from qat_vit_tpu_torch.tracking import NullRun, make_tracker
from qat_vit_tpu_torch.train.config import DEFAULT_HPARAMS, save_effective_hparams
from qat_vit_tpu_torch.train.detect_steps import (
    detect_loss_hparams,
    detection_agreement,
    make_detect_eval_step,
    make_detect_train_step,
)
from qat_vit_tpu_torch.train.steps import TrainState, data_parallel, init_quant_stats
from qat_vit_tpu_torch.train.trainer import (
    KDQATTrainer,
    entry_device,
    epoch_metrics,
    log_epoch,
    progress,
    shared_teacher,
    student_qconfig,
    trainer_mesh,
)
from qat_vit_tpu_torch.utils.checkpoint import BestCheckpointer, load_checkpoint, save_checkpoint

logger = logging.getLogger(__name__)

_GEOMETRY = ("patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio")


def _freeze_teacher(module: Owlv2Detector, device) -> Owlv2Detector:
    """The frozen teacher with bf16 weights, as the JAX trainer casts the
    teacher's params: the tower stores bf16; the float heads keep f32
    storage of the bf16-rounded values (they compute in f32, as flax
    promotes)."""
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(p.to(torch.bfloat16))
    module.vision.to(dtype=torch.bfloat16)
    return module.to(device).requires_grad_(False)


class DetectKDTrainer:
    """The detection KD + QAT engine on this process's device (``device``
    is required); in a process group every rank builds one. ``seed``,
    ``teacher_params``, ``steps`` and a ``meta``-device ``student`` as in
    ``KDQATTrainer``; ``teacher_cache`` an earlier trainer's
    :meth:`teacher_cache` arrays, shared by reference."""

    # the classification trainer's parameter hand-over, optimizer, host copy,
    # step choice and resume files (the two states have one structure)
    _load = KDQATTrainer._load
    _optimizer = KDQATTrainer._optimizer
    _to_device = KDQATTrainer._to_device
    next_step_fn = KDQATTrainer.next_step_fn
    save_resume_state = KDQATTrainer.save_resume_state
    load_resume_state = KDQATTrainer.load_resume_state

    def __init__(
        self,
        hparams: Dict[str, Any],
        *,
        device,
        data: Optional[Dict[str, np.ndarray]] = None,
        run=None,
        student: Optional[ModelBundle] = None,
        teacher: Optional[ModelBundle] = None,
        teacher_params: Optional[Owlv2Detector] = None,
        seed: Optional[int] = None,
        steps: Optional[Dict[str, Any]] = None,
        teacher_cache: Optional[tuple] = None,
    ):
        self.hp = dict(hparams)
        if int(self.hp.get("model_parallel", 1)) != 1:
            raise ValueError("detection training supports pure-DP meshes only")
        self.dist = get_dist_info()
        self.mesh = trainer_mesh(self.hp)
        self.run = run if run is not None else NullRun()
        self.device = torch.device(device)
        seed = int(self.hp["seed"] if seed is None else seed)
        image_size = int(self.hp["image_size"])
        self.image_size = image_size
        self.text_dim = int(self.hp.get("text_dim", 512))
        self.num_queries = int(self.hp.get("num_queries", 4))

        # ---- models: a frozen bf16 teacher detector, two student configs ----
        gen = torch.Generator().manual_seed(seed)
        geo = {k: self.hp[k] for k in _GEOMETRY if k in self.hp}
        if teacher_params is not None:
            # an earlier trainer's frozen teacher (a search trial): nothing
            # to build, load or cast
            self.teacher = shared_teacher(teacher, teacher_params)
        else:
            self.teacher = teacher if teacher is not None else create_model(
                "owlv2_base_detector", image_size=image_size, text_dim=self.text_dim,
                dtype=torch.bfloat16, generator=gen, **geo)
            if self.hp.get("teacher_ckpt"):
                params = load_checkpoint(self.hp["teacher_ckpt"])
                load_jax_variables(self.teacher.module, params.get("params", params))
                logger.info("loaded teacher detector from %s", self.hp["teacher_ckpt"])
            elif teacher is None:
                logger.warning("teacher detector is randomly initialized (no teacher_ckpt; real "
                               "deployments convert an HF Owlv2ForObjectDetection checkpoint "
                               "via models.owlv2_detect.owlv2_detection_to_params)")
            _freeze_teacher(self.teacher.module, self.device)
        # the frozen teacher on the device, for the next trainer's teacher_params
        self.teacher_params = self.teacher.module
        base = with_weights(student, gen) if student is not None else create_model(
            "owlv2_pruned_detector", image_size=image_size, text_dim=self.text_dim,
            generator=gen, **geo)
        dtype = torch.bfloat16 if self.hp.get("amp", True) else torch.float32
        qat_dtype = torch.bfloat16 if self.hp.get("qat_amp", False) else torch.float32
        fast = bool(self.hp.get("amp_fast_math", True))
        self.student_float_cfg = dataclasses.replace(
            base.cfg, quant=None, qat_wrapper=False, dtype=dtype,
            fast_math=fast and dtype == torch.bfloat16, attn_kernel=True)
        self.student_qat_cfg = dataclasses.replace(
            base.cfg, quant=student_qconfig(self.hp), qat_wrapper=True, dtype=qat_dtype,
            fast_math=fast and qat_dtype == torch.bfloat16, attn_kernel=True)
        self.student_float = self._load(Owlv2Detector(self.student_float_cfg, self.text_dim),
                                        base.module)
        self.student_qat = Owlv2Detector(self.student_qat_cfg, self.text_dim).to(self.device)

        # fixed unit-norm query embeddings for the run; query_seed (>= 0) pins
        # them apart from the seed, so that one teacher-output cache stays valid
        qseed = int(self.hp.get("query_seed", -1))
        q = torch.randn(self.num_queries, self.text_dim,
                        generator=torch.Generator().manual_seed(qseed if qseed >= 0 else seed))
        self.queries = (q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)).numpy()

        # ---- optimizer + state ----
        self.state = TrainState(self.student_float,
                                self._optimizer(self.student_float, float(self.hp["lr"])),
                                replica=data_parallel(self.student_float))
        self.qat_enabled = False
        self.loss_hp = detect_loss_hparams(self.hp, self.device)

        # ---- steps (shareable across trainers of one architecture: steps=) ----
        self.cache_teacher = bool(self.hp.get("cache_teacher_logits", True))
        step_teacher = None if self.cache_teacher else self.teacher.module
        shared = steps if steps is not None else {}
        self.train_step_float = shared.get("train_float") or make_detect_train_step(
            step_teacher, qat=False, image_size=image_size)
        self.train_step_qat = shared.get("train_qat") or make_detect_train_step(
            step_teacher, qat=True, image_size=image_size)
        self.observer_interval = max(1, int(self.hp.get("observer_interval", 1)))
        self.train_step_qat_frozen = shared.get("train_qat_frozen") or (make_detect_train_step(
            step_teacher, qat=True, image_size=image_size, observe=False,
        ) if self.observer_interval > 1 else None)
        self._qat_py_step = 0
        self.eval_step = shared.get("eval") or make_detect_eval_step(
            self.teacher.module, image_size=image_size)
        self._prep = preprocess_fn(image_size)
        # the teacher-output cache (host RAM): logits, boxes, objectness, filled
        # rows; a search trial takes an earlier trial's arrays by reference
        # (one query set, query_seed), so rows one trial fills serve the next
        self._t_logits: Optional[np.ndarray] = None
        self._t_boxes: Optional[np.ndarray] = None
        self._t_obj: Optional[np.ndarray] = None
        self._teacher_mask: Optional[np.ndarray] = None
        if teacher_cache is not None:
            self._t_logits, self._t_boxes, self._t_obj, self._teacher_mask = teacher_cache

        # ---- data: images only (the teacher supplies the targets) ----
        if data is None:
            data, source = load_cifar10(self.hp.get("data_dir", "./data"))
            logger.info("detection image source: %s", source)
            if source == "synthetic":
                self.run.set_tag("data_source", "synthetic")
        self.data = data
        self.eval_batch_size = int(self.hp.get("eval_batch_size", 64))
        self.train_loader = ArrayLoader(data["train_images"], data["train_labels"],
                                        batch_size=int(self.hp["batch_size"]), shuffle=True,
                                        seed=seed, rank=self.dist.rank,
                                        world_size=self.dist.world_size, drop_last=True)
        self.eval_loader = ArrayLoader(data["test_images"], data["test_labels"],
                                       batch_size=self.eval_batch_size, shuffle=False,
                                       drop_last=False)

    # ------------------------------------------------------------------
    def shared_steps(self) -> Dict[str, Any]:
        """The step functions, for the next trainer of the same architecture
        and teacher (``steps=``)."""
        return {
            "train_float": self.train_step_float,
            "train_qat": self.train_step_qat,
            "eval": self.eval_step,
            "train_qat_frozen": self.train_step_qat_frozen,
        }

    def teacher_cache(self) -> Optional[tuple]:
        """The shareable ``(logits, boxes, obj, mask)`` cache arrays, or None
        if the cache was never allocated."""
        if self._teacher_mask is None:
            return None
        return (self._t_logits, self._t_boxes, self._t_obj, self._teacher_mask)

    # ------------------------------------------------------------------
    def enable_qat(self) -> None:
        """The QAT phase switch: the QAT student takes the float student's
        parameters, fresh observers (±inf), fresh AdamW moments at
        LR × ``qat_lr_scale``."""
        if self.qat_enabled:
            return
        self._load(self.student_qat, self.student_float)
        init_quant_stats(self.student_qat)
        lr = float(self.hp["lr"]) * float(self.hp.get("qat_lr_scale", 0.5))
        self.state = TrainState(self.student_qat, self._optimizer(self.student_qat, lr),
                                self.state.step, replica=data_parallel(self.student_qat))
        self.qat_enabled = True
        self._qat_py_step = 0  # the first QAT step observes (the ±inf markers)
        logger.info("detection QAT enabled (lr -> %.3g)", lr)

    # ------------------------------------------------------------------
    def _queries_for(self, n: int) -> torch.Tensor:
        q = torch.from_numpy(np.ascontiguousarray(self.queries, dtype=np.float32))
        return q.to(self.device).expand(n, self.num_queries, self.text_dim)

    @torch.no_grad()
    def _teacher_forward(self, images: np.ndarray):
        """The frozen teacher's f32 (logits, boxes, objectness) for a host
        image chunk, as numpy."""
        out = self.teacher.module(self._prep(self._to_device(images)),
                                  self._queries_for(len(images)), observe=False)
        return tuple(out[k].to(torch.float32).cpu().numpy()
                     for k in ("logits", "pred_boxes", "objectness_logits"))

    def _ensure_teacher_outputs(self, lazy: bool = False) -> None:
        """The frozen teacher's outputs over the train images, once: eagerly
        in eval-batch chunks, or (``lazy``) as rows are first visited by
        :meth:`_teacher_outputs_for`."""
        if not self.cache_teacher or self._teacher_mask is not None:
            return
        imgs = self.data["train_images"]
        n, p = len(imgs), self.teacher.cfg.num_patches
        self._t_logits = np.zeros((n, p, self.num_queries), np.float32)
        self._t_boxes = np.zeros((n, p, 4), np.float32)
        self._t_obj = np.zeros((n, p), np.float32)
        self._teacher_mask = np.zeros(n, bool)
        if lazy:
            logger.info("teacher output cache: lazy (limited-batch run)")
            return
        t0 = time.perf_counter()
        for s in range(0, n, self.eval_batch_size):
            e = min(s + self.eval_batch_size, n)
            self._t_logits[s:e], self._t_boxes[s:e], self._t_obj[s:e] = self._teacher_forward(
                imgs[s:e])
        self._teacher_mask[:] = True
        logger.info("cached teacher detection outputs for %d images in %.1fs", n,
                    time.perf_counter() - t0)

    def _teacher_outputs_for(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Cached teacher outputs for one batch, filling misses."""
        idx = batch["index"]
        if not self._teacher_mask[idx].all():
            self._t_logits[idx], self._t_boxes[idx], self._t_obj[idx] = self._teacher_forward(
                batch["image"])
            self._teacher_mask[idx] = True
        return {"t_logits": self._t_logits[idx], "t_boxes": self._t_boxes[idx],
                "t_obj": self._t_obj[idx]}

    def train_epoch(self, epoch: int, limit_batches: int = 0) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        lazy = False
        if limit_batches:
            planned = (limit_batches * int(self.hp["batch_size"]) * self.dist.world_size
                       * max(1, int(self.hp.get("epochs", 1))))
            lazy = planned < len(self.data["train_images"]) // 2
        self._ensure_teacher_outputs(lazy=lazy)
        device_metrics = []  # 0-d device tensors: no host sync until the epoch ends
        n_images = 0
        t0 = time.perf_counter()
        loader = progress(self.train_loader, self.hp, self.dist, epoch, limit_batches)
        for i, batch in enumerate(loader):
            if limit_batches and i >= limit_batches:
                break
            n = len(batch["image"])
            dev_batch = {"image": self._to_device(batch["image"]),
                         "query_embeds": self._queries_for(n)}
            if self.cache_teacher:
                for k, v in self._teacher_outputs_for(batch).items():
                    dev_batch[k] = torch.from_numpy(v).to(self.device)
            device_metrics.append(self.next_step_fn()(self.state, dev_batch, self.loss_hp))
            n_images += n * self.dist.world_size
        return epoch_metrics(device_metrics, n_images, t0)

    # ------------------------------------------------------------------
    def _padded_eval_batches(self, limit_batches: int = 0):
        """Eval batches padded to ``eval_batch_size`` on the device, with the
        queries and a ``valid`` row mask (one batch shape for every eval
        path, as the JAX trainer)."""
        bs = self.eval_batch_size
        for i, batch in enumerate(self.eval_loader):
            if limit_batches and i >= limit_batches:
                break
            images = batch["image"]
            n = len(images)
            if n < bs:
                images = np.concatenate([images, np.zeros((bs - n,) + images.shape[1:],
                                                          images.dtype)])
            yield {"image": self._to_device(images), "query_embeds": self._queries_for(bs),
                   "valid": (torch.arange(bs) < n).to(torch.float32).to(self.device)}

    @staticmethod
    def _means(sums) -> tuple:
        """(mean |Δbox|, mean top-box agreement) over the images of the
        batches' :func:`detection_agreement` sums."""
        if not sums:
            return 0.0, 0.0
        tot = {k: float(torch.stack([s[k] for s in sums]).sum()) for k in sums[0]}
        n = max(tot["n"], 1.0)
        return tot["box_err_sum"] / n, tot["agree_sum"] / n

    def evaluate(self, limit_batches: int = 0) -> Dict[str, float]:
        """Teacher-relative detection metrics of the current (float or
        fake-quant) student over the eval images, observers frozen."""
        module = self.student_qat if self.qat_enabled else self.student_float
        box, agree = self._means([self.eval_step(module, b)
                                  for b in self._padded_eval_batches(limit_batches)])
        return {"box_err": box, "teacher_agreement": agree}

    def convert_int8(self) -> Dict[str, Any]:
        """Observer folding → the int8 detection export (int8 tower + float
        heads, CPU tensors)."""
        if not self.qat_enabled:
            raise RuntimeError("convert requires QAT to have run")
        sd = self.student_qat.state_dict()
        return convert_detector(sd, sd, self.student_qat_cfg,
                                per_channel_weights=bool(self.hp.get("per_channel_weights", False)))

    @torch.no_grad()
    def evaluate_int8(self, export=None, limit_batches: int = 0) -> Dict[str, float]:
        """The int8 detector (``make_int8_detect_forward``: on CUDA the
        serving preset's kernel chain) against the fake-quant detector it was
        converted from: mean |Δbox| and top-box agreement, over the same
        padded eval batches as :meth:`evaluate`."""
        export = export_to_device(export if export is not None else self.convert_int8(),
                                  self.device)
        fwd = make_int8_detect_forward(self.student_qat_cfg, self.device)
        sums = []
        for b in self._padded_eval_batches(limit_batches):
            x, q = self._prep(b["image"]), b["query_embeds"]
            sums.append(detection_agreement(fwd(export, x, q),
                                            self.student_qat(x, q, observe=False), b["valid"]))
        box, agree = self._means(sums)
        return {"int8_box_err": box, "int8_top_box_agreement": agree}


def detect_train_main(hp: Dict[str, Any], device="cuda", **trainer_kw) -> Dict[str, Any]:
    """The whole detection run behind ``--task detection`` (the JAX
    package's ``detect_train_main``): ``effective_hparams.yaml``, a tracker
    run, the best-model rule on teacher agreement (``best_qat_detector``),
    the int8 export of the last epoch (``best_converted_detector.msgpack``)
    with its metrics logged at the end, ``resume_state.msgpack`` every
    epoch. A CUDA ``device`` must be present (pass ``device="cpu"`` for the
    CPU); ``trainer_kw`` (``data``, ``student``, ``teacher``) go to the
    trainer. In a process group every rank calls it, as ``train_main``."""
    device = entry_device(device)
    dist = get_dist_info()
    output_dir = hp["output_dir"]
    if dist.is_main_process:
        os.makedirs(output_dir, exist_ok=True)
        save_effective_hparams(hp, output_dir)
        tracker = make_tracker(hp["mlflow_uri"], hp["experiment"])
        run = tracker.start_run("final_train_detection")
        run.log_params({k: hp[k] for k in DEFAULT_HPARAMS if not isinstance(hp[k], dict)})
    else:
        run = NullRun()
    barrier("dataset")

    trainer = DetectKDTrainer(hp, device=device, run=run, **trainer_kw)
    best = BestCheckpointer(output_dir, "best_qat_detector")
    epochs = int(hp["epochs"])
    qat_start = int(hp["qat_start_epoch"])
    limit_train = int(hp.get("limit_train_batches", 0))
    limit_eval = int(hp.get("limit_eval_batches", 0))
    results = []
    int8_metrics: Dict[str, float] = {}
    start_epoch = 0
    if hp.get("resume"):
        start_epoch = trainer.load_resume_state(hp["resume"])
        logger.info("resumed from %s at epoch %d", hp["resume"], start_epoch)
    for epoch in range(start_epoch, epochs):
        if epoch >= qat_start:
            trainer.enable_qat()
        tm = trainer.train_epoch(epoch, limit_batches=limit_train)
        barrier("epoch")
        ev = trainer.evaluate(limit_batches=limit_eval)
        if epoch == epochs - 1 and trainer.qat_enabled:
            export = trainer.convert_int8()
            int8_metrics = trainer.evaluate_int8(export, limit_batches=limit_eval)
            if dist.is_main_process:
                save_checkpoint(os.path.join(output_dir, "best_converted_detector.msgpack"),
                                export, {"epoch": epoch, "format": "int8-tower+float-heads",
                                         **int8_metrics})
        if dist.is_main_process:
            run.log_metrics({**{k: tm.get(k, 0.0) for k in ("train_loss", "train_loss_kd",
                                                              "train_loss_box", "train_loss_obj")},
                             **ev, "imgs_per_sec": tm["imgs_per_sec"],
                             "qat_enabled": float(trainer.qat_enabled)}, step=epoch)
            logger.info("epoch %d/%d loss %.4f box_err %.4f agree %.3f (%.0f img/s)%s",
                        epoch + 1, epochs, tm.get("train_loss", 0.0), ev["box_err"],
                        ev["teacher_agreement"], tm["imgs_per_sec"],
                        " [QAT]" if trainer.qat_enabled else "")
            # the classification rule on teacher agreement: a float epoch may
            # win it, and then the file holds float params and empty stats
            # (its metadata's qat_enabled says so)
            sd = trainer.state.module.state_dict()
            best.maybe_save(
                ev["teacher_agreement"],
                {"params": state_dict_to_params(sd),
                 "quant_stats": buffers_to_quant_stats(sd) if trainer.qat_enabled else {}},
                {"epoch": epoch, **ev, "qat_enabled": trainer.qat_enabled})
        log_epoch(dist, epoch, tm, ev)
        if dist.is_main_process and hp.get("save_resume_state", True):
            trainer.save_resume_state(os.path.join(output_dir, "resume_state.msgpack"), epoch)
        results.append({"epoch": epoch, **tm, **ev, "qat_enabled": trainer.qat_enabled})
        barrier("epoch_end")

    if dist.is_main_process:
        for k, v in int8_metrics.items():
            run.log_metric(k, v)
        run.end("FINISHED")
    return {"results": results, "int8": int8_metrics, "output_dir": output_dir}
