"""KD + QAT trainer on one device (port of ``qat_vit_tpu/train/trainer.py``).

A frozen ViT-B teacher distils into a ViT-S student on CIFAR-10 with
α·KL·T² + (1−α)·CE(label smoothing), AdamW + clip(1.0); at
``qat_start_epoch`` the caller switches to QAT (:meth:`KDQATTrainer.
enable_qat`: fresh observers, fresh optimizer moments at LR ×
``qat_lr_scale``); after training, :meth:`convert_int8` folds the observers
into the int8 export and :meth:`evaluate_int8` runs it through the serving
preset (the hand-written int8 kernels on CUDA).

``student_family="owlv2"`` trains the OWLv2 vision towers as classifiers
(``owlv2_base_teacher`` into ``owlv2_student_pruned``), as the JAX trainer
does; at 768 px their attention takes the long-sequence kernels.

Configs, as the JAX trainer builds them under its defaults: the float
student in bf16 with fast_math, the QAT student in bf16 (``qat_amp``) with
fast_math and ``fq_in_kernel``, so every training step's attention runs
through the hand-written kernels (``ops/flash_attention_train.py``). The two
students are two modules; the QAT one takes the float one's parameters at
the switch.

Teacher and student weights come from files (``teacher_ckpt``,
``student_ckpt``: a timm-layout ``.pth`` / ``.bin`` / ``.pt`` through
``models/torch_convert.py``, or the JAX package's msgpack, see
:func:`load_model_params`). Not ported yet: resume, ``observer_interval`` >
1, ``observer_stride`` > 1 and tensor parallelism raise when the
hyperparameters ask for them; tracking, multi-device data parallelism,
``train_main`` and the CLI are absent (ROADMAP.md Queue 1, items 5 and 6).
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
from qat_vit_tpu_torch.models.jax_params import load_jax_variables, state_dict_to_params
from qat_vit_tpu_torch.models.registry import ModelBundle, create_student, create_teacher
from qat_vit_tpu_torch.models.torch_convert import load_torch_state_dict, timm_vit_to_params
from qat_vit_tpu_torch.models.vit import VisionTransformer
from qat_vit_tpu_torch.quant.qconfig import default_qat_qconfig
from qat_vit_tpu_torch.serve.int8_vit import convert_vit
from qat_vit_tpu_torch.serve.predictor import Int8Predictor
from qat_vit_tpu_torch.train.steps import (
    TrainState,
    init_quant_stats,
    loss_hparams,
    make_eval_step,
    make_optimizer,
    make_train_step,
    set_optimizer_hyperparams,
)
from qat_vit_tpu_torch.utils.checkpoint import load_checkpoint, tolerant_merge

logger = logging.getLogger(__name__)

_NOT_PORTED = "is not ported yet: ROADMAP.md Queue 1, item {}"


def refuse_unported(hp: Dict[str, Any]) -> None:
    """Raise on options the port does not run yet, rather than ignore them."""
    checks = [
        (int(hp.get("model_parallel", 1)) != 1, "model_parallel > 1 (tensor parallelism)", 11),
        (int(hp.get("observer_interval", 1)) != 1, "observer_interval > 1", 6),
        (int(hp.get("observer_stride", 1)) != 1, "observer_stride > 1", 2),
        (bool(hp.get("resume")), "resume", 6),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(f"{what} {_NOT_PORTED.format(item)}")


def load_model_params(path: str, cfg, template=None) -> Dict[str, Any]:
    """Model weights in the JAX package's layout (numpy), from a torch
    ``.pth`` / ``.bin`` / ``.pt`` in timm layout (converted on the fly) or from
    a msgpack checkpoint (its ``"params"`` when it holds one). Tolerant
    restore against ``template`` when given (the reference's ``strict=False``
    loaders); without one a ``.pth`` must convert with no key left over."""
    if path.endswith((".pth", ".bin", ".pt")):
        state = load_torch_state_dict(path)
        return timm_vit_to_params(state, cfg, strict=template is None)
    restored = load_checkpoint(path)
    if "params" in restored:
        restored = restored["params"]
    if template is not None:
        merged, _, _ = tolerant_merge(dict(template), restored)
        return merged
    return restored


class KDQATTrainer:
    """The KD + QAT engine on one device (``device`` is required: nothing
    moves to another device on its own)."""

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
        num_classes = int(self.hp["num_classes"])
        self.image_size = image_size

        # ---- models: a frozen bf16 teacher, two student configs ----
        gen = torch.Generator().manual_seed(seed)
        family = self.hp.get("student_family", "vit")
        self.teacher = teacher if teacher is not None else create_teacher(
            family, num_classes=num_classes, dtype=torch.bfloat16, image_size=image_size,
            generator=gen)
        if self.hp.get("teacher_ckpt"):
            load_jax_variables(self.teacher.module,
                               load_model_params(self.hp["teacher_ckpt"], self.teacher.cfg))
            logger.info("loaded teacher weights from %s", self.hp["teacher_ckpt"])
        elif teacher is None:
            logger.warning("teacher is randomly initialized (no teacher_ckpt given; the "
                           "reference downloads pretrained weights, which needs network)")
        self.teacher.module.to(device=self.device, dtype=torch.bfloat16).requires_grad_(False)
        base = student if student is not None else create_student(
            family, num_classes=num_classes, image_size=image_size, generator=gen)
        dtype = torch.bfloat16 if self.hp.get("amp", True) else torch.float32
        qat_dtype = torch.bfloat16 if self.hp.get("qat_amp", False) else torch.float32
        fast = bool(self.hp.get("amp_fast_math", True))
        remat = str(self.hp.get("remat", "none"))
        self.student_float_cfg = dataclasses.replace(
            base.cfg, quant=None, qat_wrapper=False, dtype=dtype,
            fast_math=fast and dtype == torch.bfloat16, attn_kernel=True, remat=remat)
        self.student_qat_cfg = dataclasses.replace(
            base.cfg, quant=default_qat_qconfig(self.hp.get("qat_backend", "qnnpack")),
            qat_wrapper=True, dtype=qat_dtype, fast_math=fast and qat_dtype == torch.bfloat16,
            attn_kernel=True, remat=remat, fq_in_kernel=bool(self.hp.get("fq_in_kernel", False)))
        self.student_float = self._load(VisionTransformer(self.student_float_cfg), base.module)
        if self.hp.get("student_ckpt"):
            template = state_dict_to_params(self.student_float.state_dict())
            load_jax_variables(self.student_float, load_model_params(
                self.hp["student_ckpt"], self.student_float_cfg, template=template))
            logger.info("loaded student weights from %s", self.hp["student_ckpt"])
        self.student_qat = VisionTransformer(self.student_qat_cfg).to(self.device)

        # ---- optimizer + state ----
        self.state = TrainState(self.student_float,
                                self._optimizer(self.student_float, float(self.hp["lr"])))
        self.qat_enabled = False
        self.loss_hp = loss_hparams(self.hp, self.device)

        # ---- steps ----
        self.cache_teacher = bool(self.hp.get("cache_teacher_logits", True))
        step_teacher = None if self.cache_teacher else self.teacher.module
        self.train_step_float = make_train_step(step_teacher, qat=False, image_size=image_size)
        self.train_step_qat = make_train_step(step_teacher, qat=True, image_size=image_size)
        self.eval_step = make_eval_step(image_size)
        self._prep = preprocess_fn(image_size)
        self._teacher_logits: Optional[np.ndarray] = None
        self._teacher_mask: Optional[np.ndarray] = None

        # ---- data ----
        if data is None:
            data, source = load_cifar10(self.hp.get("data_dir", "./data"))
            logger.info("CIFAR-10 source: %s", source)
        self.data = data
        self.train_loader = ArrayLoader(data["train_images"], data["train_labels"],
                                        batch_size=int(self.hp["batch_size"]), shuffle=True,
                                        seed=seed, drop_last=True)
        self.eval_loader = ArrayLoader(data["test_images"], data["test_labels"],
                                       batch_size=int(self.hp.get("eval_batch_size", 512)),
                                       shuffle=False, drop_last=False)

    # ------------------------------------------------------------------
    def _load(self, module: VisionTransformer, src: torch.nn.Module) -> VisionTransformer:
        """``module`` on the device with ``src``'s parameters (observer
        buffers are not copied)."""
        params = {k: v for k, v in src.state_dict().items()
                  if not k.endswith((".min_val", ".max_val"))}
        missing, unexpected = module.load_state_dict(params, strict=False)
        missing = [k for k in missing if not k.endswith((".min_val", ".max_val"))]
        if missing or unexpected:
            raise ValueError(f"student params do not match: missing {missing}, "
                             f"unexpected {unexpected}")
        return module.to(self.device)

    def _optimizer(self, module: torch.nn.Module, lr: float):
        wd = float(self.hp["weight_decay"])
        opt = make_optimizer(module.parameters(), lr, wd, float(self.hp.get("grad_clip_norm", 1.0)))
        return set_optimizer_hyperparams(opt, learning_rate=lr, weight_decay=wd)

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
        logger.info("QAT enabled (lr -> %.3g)", lr)

    # ------------------------------------------------------------------
    def _to_device(self, images: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    @torch.no_grad()
    def _teacher_forward(self, images: np.ndarray) -> np.ndarray:
        x = self._prep(self._to_device(images))
        return self.teacher.module(x, observe=False).to(torch.float32).cpu().numpy()

    def _ensure_teacher_logits(self, lazy: bool = False) -> None:
        """The frozen teacher's logits over the train set, once: eagerly, or
        (``lazy``) as rows are first visited by :meth:`_teacher_logits_for`."""
        if not self.cache_teacher or self._teacher_logits is not None:
            return
        imgs = self.data["train_images"]
        n_classes = int(self.hp["num_classes"])
        if lazy:
            self._teacher_logits = np.zeros((len(imgs), n_classes), np.float32)
            self._teacher_mask = np.zeros(len(imgs), bool)
            return
        bs = int(self.hp.get("eval_batch_size", 512))
        t0 = time.perf_counter()
        self._teacher_logits = np.concatenate(
            [self._teacher_forward(imgs[s : s + bs]) for s in range(0, len(imgs), bs)])
        self._teacher_mask = np.ones(len(imgs), bool)
        logger.info("cached teacher logits for %d images in %.1fs",
                    len(imgs), time.perf_counter() - t0)

    def _teacher_logits_for(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Cached teacher logits for one batch, filling misses."""
        idx = batch["index"]
        if not self._teacher_mask[idx].all():
            self._teacher_logits[idx] = self._teacher_forward(batch["image"])
            self._teacher_mask[idx] = True
        return self._teacher_logits[idx]

    def train_epoch(self, epoch: int, limit_batches: int = 0) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        lazy = False
        if limit_batches:
            planned = (limit_batches * int(self.hp["batch_size"])
                       * max(1, int(self.hp.get("epochs", 1))))
            lazy = planned < len(self.data["train_images"]) // 2
        self._ensure_teacher_logits(lazy=lazy)
        step_fn = self.train_step_qat if self.qat_enabled else self.train_step_float
        device_metrics = []  # 0-d device tensors: no host sync until the epoch ends
        n_images = 0
        t0 = time.perf_counter()
        for i, batch in enumerate(self.train_loader):
            if limit_batches and i >= limit_batches:
                break
            dev_batch = {
                "image": self._to_device(batch["image"]),
                "label": torch.from_numpy(batch["label"].astype(np.int64)).to(self.device),
            }
            if self.cache_teacher:
                dev_batch["teacher_logits"] = torch.from_numpy(
                    self._teacher_logits_for(batch)).to(self.device)
            device_metrics.append(step_fn(self.state, dev_batch, self.loss_hp))
            n_images += len(batch["label"])
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
    def _eval_batches(self, limit_batches: int):
        for i, batch in enumerate(self.eval_loader):
            if limit_batches and i >= limit_batches:
                break
            yield batch

    def evaluate(self, limit_batches: int = 0) -> float:
        """Top-1 on the test set with the current (float or fake-quant)
        student, observers frozen."""
        module = self.student_qat if self.qat_enabled else self.student_float
        correct, total = [], 0
        for batch in self._eval_batches(limit_batches):
            label = torch.from_numpy(batch["label"].astype(np.int64)).to(self.device)
            correct.append(self.eval_step(module, {"image": self._to_device(batch["image"]),
                                                   "label": label}))
            total += len(batch["label"])
        return float(torch.stack(correct).sum()) / max(total, 1) if correct else 0.0

    def convert_int8(self) -> Dict[str, Any]:
        """Observer folding → the int8 export (CPU tensors)."""
        if not self.qat_enabled:
            raise RuntimeError("convert requires QAT to have run")
        sd = self.student_qat.state_dict()
        return convert_vit(sd, sd, self.student_qat_cfg,
                           per_channel_weights=bool(self.hp.get("per_channel_weights", False)))

    def evaluate_int8(self, qparams=None, limit_batches: int = 0) -> float:
        """True-int8 top-1 through the serving preset on this device."""
        qparams = qparams if qparams is not None else self.convert_int8()
        pred = Int8Predictor(qparams, self.student_qat_cfg,
                             batch_size=int(self.hp.get("eval_batch_size", 512)),
                             device=self.device)
        correct, total = 0, 0
        for batch in self._eval_batches(limit_batches):
            correct += int((pred.predict(batch["image"]) == batch["label"]).sum())
            total += len(batch["label"])
        return correct / max(total, 1)
