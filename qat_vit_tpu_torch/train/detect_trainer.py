"""Detection KD + QAT trainer on one device: distil a teacher OWLv2 detector
into a pruned, QAT-armed student detector (port of
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
registry's. Not ported, as for classification (``train/trainer.py``):
resume, ``observer_interval`` > 1, ``observer_stride`` > 1 and model
parallelism raise; ``detect_train_main``, checkpoints of the run and
tracking are absent (ROADMAP.md Queue 1, items 6 and 10).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from qat_vit_tpu_torch.data.cifar10 import load_cifar10
from qat_vit_tpu_torch.data.pipeline import ArrayLoader, preprocess_fn
from qat_vit_tpu_torch.models.jax_params import load_jax_variables
from qat_vit_tpu_torch.models.owlv2_detect import Owlv2Detector
from qat_vit_tpu_torch.models.registry import ModelBundle, create_model
from qat_vit_tpu_torch.quant.qconfig import default_qat_qconfig
from qat_vit_tpu_torch.serve.int8_detect import convert_detector, make_int8_detect_forward
from qat_vit_tpu_torch.serve.int8_vit import export_to_device
from qat_vit_tpu_torch.train.detect_steps import (
    detect_loss_hparams,
    detection_agreement,
    make_detect_eval_step,
    make_detect_train_step,
)
from qat_vit_tpu_torch.train.steps import TrainState, init_quant_stats
from qat_vit_tpu_torch.train.trainer import KDQATTrainer, refuse_unported
from qat_vit_tpu_torch.utils.checkpoint import load_checkpoint

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
    """The detection KD + QAT engine on one device (``device`` is required)."""

    # the classification trainer's parameter hand-over, optimizer and host copy
    _load = KDQATTrainer._load
    _optimizer = KDQATTrainer._optimizer
    _to_device = KDQATTrainer._to_device

    def __init__(
        self,
        hparams: Dict[str, Any],
        *,
        device,
        data: Optional[Dict[str, np.ndarray]] = None,
        student: Optional[ModelBundle] = None,
        teacher: Optional[ModelBundle] = None,
    ):
        self.hp = dict(hparams)
        refuse_unported(self.hp)
        self.device = torch.device(device)
        seed = int(self.hp["seed"])
        image_size = int(self.hp["image_size"])
        self.image_size = image_size
        self.text_dim = int(self.hp.get("text_dim", 512))
        self.num_queries = int(self.hp.get("num_queries", 4))

        # ---- models: a frozen bf16 teacher detector, two student configs ----
        gen = torch.Generator().manual_seed(seed)
        geo = {k: self.hp[k] for k in _GEOMETRY if k in self.hp}
        self.teacher = teacher if teacher is not None else create_model(
            "owlv2_base_detector", image_size=image_size, text_dim=self.text_dim,
            dtype=torch.bfloat16, generator=gen, **geo)
        if self.hp.get("teacher_ckpt"):
            params = load_checkpoint(self.hp["teacher_ckpt"])
            load_jax_variables(self.teacher.module, params.get("params", params))
            logger.info("loaded teacher detector from %s", self.hp["teacher_ckpt"])
        elif teacher is None:
            logger.warning("teacher detector is randomly initialized (no teacher_ckpt; real "
                           "deployments convert an HF Owlv2ForObjectDetection checkpoint via "
                           "models.owlv2_detect.owlv2_detection_to_params)")
        _freeze_teacher(self.teacher.module, self.device)
        base = student if student is not None else create_model(
            "owlv2_pruned_detector", image_size=image_size, text_dim=self.text_dim,
            generator=gen, **geo)
        dtype = torch.bfloat16 if self.hp.get("amp", True) else torch.float32
        qat_dtype = torch.bfloat16 if self.hp.get("qat_amp", False) else torch.float32
        fast = bool(self.hp.get("amp_fast_math", True))
        self.student_float_cfg = dataclasses.replace(
            base.cfg, quant=None, qat_wrapper=False, dtype=dtype,
            fast_math=fast and dtype == torch.bfloat16, attn_kernel=True)
        self.student_qat_cfg = dataclasses.replace(
            base.cfg, quant=default_qat_qconfig(self.hp.get("qat_backend", "qnnpack")),
            qat_wrapper=True, dtype=qat_dtype, fast_math=fast and qat_dtype == torch.bfloat16,
            attn_kernel=True)
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
                                self._optimizer(self.student_float, float(self.hp["lr"])))
        self.qat_enabled = False
        self.loss_hp = detect_loss_hparams(self.hp, self.device)

        # ---- steps ----
        self.cache_teacher = bool(self.hp.get("cache_teacher_logits", True))
        step_teacher = None if self.cache_teacher else self.teacher.module
        self.train_step_float = make_detect_train_step(step_teacher, qat=False,
                                                       image_size=image_size)
        self.train_step_qat = make_detect_train_step(step_teacher, qat=True,
                                                     image_size=image_size)
        self.eval_step = make_detect_eval_step(self.teacher.module, image_size=image_size)
        self._prep = preprocess_fn(image_size)
        # the teacher-output cache (host RAM): logits, boxes, objectness, filled rows
        self._t_logits: Optional[np.ndarray] = None
        self._t_boxes: Optional[np.ndarray] = None
        self._t_obj: Optional[np.ndarray] = None
        self._teacher_mask: Optional[np.ndarray] = None

        # ---- data: images only (the teacher supplies the targets) ----
        if data is None:
            data, source = load_cifar10(self.hp.get("data_dir", "./data"))
            logger.info("detection image source: %s", source)
        self.data = data
        self.eval_batch_size = int(self.hp.get("eval_batch_size", 64))
        self.train_loader = ArrayLoader(data["train_images"], data["train_labels"],
                                        batch_size=int(self.hp["batch_size"]), shuffle=True,
                                        seed=seed, drop_last=True)
        self.eval_loader = ArrayLoader(data["test_images"], data["test_labels"],
                                       batch_size=self.eval_batch_size, shuffle=False,
                                       drop_last=False)

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
                                self.state.step)
        self.qat_enabled = True
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
            planned = (limit_batches * int(self.hp["batch_size"])
                       * max(1, int(self.hp.get("epochs", 1))))
            lazy = planned < len(self.data["train_images"]) // 2
        self._ensure_teacher_outputs(lazy=lazy)
        step_fn = self.train_step_qat if self.qat_enabled else self.train_step_float
        device_metrics = []  # 0-d device tensors: no host sync until the epoch ends
        n_images = 0
        t0 = time.perf_counter()
        for i, batch in enumerate(self.train_loader):
            if limit_batches and i >= limit_batches:
                break
            n = len(batch["image"])
            dev_batch = {"image": self._to_device(batch["image"]),
                         "query_embeds": self._queries_for(n)}
            if self.cache_teacher:
                for k, v in self._teacher_outputs_for(batch).items():
                    dev_batch[k] = torch.from_numpy(v).to(self.device)
            device_metrics.append(step_fn(self.state, dev_batch, self.loss_hp))
            n_images += n
        if not device_metrics:
            return {"imgs_per_sec": 0.0, "epoch_seconds": time.perf_counter() - t0,
                    "n_batches": 0}
        stacked = {k: torch.stack([m[k] for m in device_metrics]).cpu()  # waits for the device
                   for k in device_metrics[0]}
        dt = time.perf_counter() - t0
        out = {k: float(v.to(torch.float64).mean()) for k, v in stacked.items()}
        out["imgs_per_sec"] = n_images / max(dt, 1e-9)
        out["epoch_seconds"] = dt
        out["n_batches"] = len(device_metrics)
        return out

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
