"""KD + QAT trainer, one device per process, and the final-training entry
point (port of ``qat_vit_tpu/train/trainer.py``).

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
the switch. ``observer_interval`` k > 1 observes on the first QAT step and
every k-th after it, and fake-quantizes from the frozen statistics in
between (a second step function, picked on the host); ``observer_stride``
s > 1 has the activation observers see the first 1/s of each batch.

Teacher and student weights come from files (``teacher_ckpt``,
``student_ckpt``: a timm-layout ``.pth`` / ``.bin`` / ``.pt`` through
``models/torch_convert.py``, or the JAX package's msgpack, see
:func:`load_model_params`). :meth:`KDQATTrainer.save_resume_state` writes
the JAX package's resume tree, so a run resumes in either package.

:func:`train_main` is the whole run (tracking, the best-model rule, the
int8 export, resume files, an optional profiled epoch); :func:`main` is the
CLI, ``python -m qat_vit_tpu_torch.train.trainer`` with the JAX package's
flags.

Data parallelism, as the JAX trainer's ``shard_map`` step: under
``torchrun`` each rank runs one process on one device
(``parallel.setup_distributed``), takes its own shard ``rank::world`` of
the same seeded shuffle at ``batch_size`` per process, and steps through a
DDP replica (gradients averaged before clip → AdamW); the activation
observers reduce their min/max over the ranks; the epoch's metrics are
averaged over the ranks with one all-reduce; eval takes the strided shard
``rank::world`` and sums the correct counts. Every rank trains, evaluates
and converts; rank 0 alone writes files and tracks.

Tensor parallelism (``model_parallel`` k > 1): the world is a ``(data,
k)`` rank grid (``parallel.make_mesh``). The student is built whole from
the seed, as in one process, then split (``parallel/tensor.py``): each model
rank holds its shard of qkv / proj / fc1 / fc2 and of their AdamW moments.
The attention kernels are off under a model axis, as JAX's gate has them
(its step runs the einsum attention there). The data shards, the image
counts and the eval shard go by data index, so the model ranks of a data
group take the same rows and the eval counts each data group once; every
observer reduces over the world. Files hold the gathered tensors in the JAX
tree, equal to one process's file of the same values; resume splits them
again on every rank.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from qat_vit_tpu_torch.data.cifar10 import load_cifar10
from qat_vit_tpu_torch.data.pipeline import ArrayLoader, preprocess_fn
from qat_vit_tpu_torch.models.jax_params import (
    buffers_to_quant_stats,
    load_jax_variables,
    params_to_state_dict,
    quant_stats_to_buffers,
    state_dict_to_params,
)
from qat_vit_tpu_torch.models.registry import (
    ModelBundle,
    create_student,
    create_teacher,
    with_weights,
)
from qat_vit_tpu_torch.models.torch_convert import load_torch_state_dict, timm_vit_to_params
from qat_vit_tpu_torch.models.vit import VisionTransformer
from qat_vit_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    all_reduce_mean,
    all_reduce_sum,
    barrier,
    cleanup_distributed,
    get_dist_info,
    is_distributed,
    make_mesh,
    setup_distributed,
)
from qat_vit_tpu_torch.parallel.tensor import gather_params, shard_module, split_params
from qat_vit_tpu_torch.quant.qconfig import QConfig, default_qat_qconfig
from qat_vit_tpu_torch.serve.int8_vit import convert_vit
from qat_vit_tpu_torch.serve.predictor import Int8Predictor
from qat_vit_tpu_torch.tracking import NullRun, enable_system_metrics_logging, make_tracker
from qat_vit_tpu_torch.train.config import (
    DEFAULT_HPARAMS,
    add_hparam_flags,
    resolve_hparams,
    save_effective_hparams,
)
from qat_vit_tpu_torch.train.steps import (
    TrainState,
    data_parallel,
    init_quant_stats,
    loss_hparams,
    make_eval_step,
    make_optimizer,
    make_train_step,
    set_optimizer_hyperparams,
)
from qat_vit_tpu_torch.utils.checkpoint import (
    BestCheckpointer,
    load_checkpoint,
    load_metadata,
    save_checkpoint,
    tolerant_merge,
)
from qat_vit_tpu_torch.utils.profiling import trace

logger = logging.getLogger(__name__)


def trainer_mesh(hp: Dict[str, Any]) -> Mesh:
    """The trainer's ``(data, model_parallel)`` rank grid: over the world in
    a process group or with ``model_parallel`` > 1 (a model axis the world
    does not divide raises, as JAX's mesh), else one rank."""
    model = int(hp.get("model_parallel", 1))
    if is_distributed() or model != 1:
        return make_mesh(model=model)
    return Mesh()


def shared_teacher(teacher: Optional[ModelBundle], module: torch.nn.Module) -> ModelBundle:
    """The bundle of a frozen teacher module handed over by an earlier
    trainer (``teacher_params``)."""
    if teacher is not None:
        return dataclasses.replace(teacher, module=module)
    return ModelBundle(name="teacher", module=module, cfg=module.cfg)


def student_qconfig(hp: Dict[str, Any], mesh: Optional[Mesh] = None) -> QConfig:
    """The QAT student's qconfig: ``qat_backend``'s, with ``observer_stride``
    on the activation observers (weight observers stay exact) and, in a
    process group, the data axis on them: their min/max reduce over the
    ranks (under data parallelism weights are the same on every rank and
    take no collective). Under a model axis (``mesh.model`` > 1) the weight
    observers reduce too (the model axis): a split weight's min/max are the
    whole tensor's."""
    qconfig = default_qat_qconfig(hp.get("qat_backend", "qnnpack"))
    act = {}
    stride = max(1, int(hp.get("observer_stride", 1)))
    if stride > 1:
        act["observe_stride"] = stride
    if is_distributed():
        act["axis_name"] = DATA_AXIS
    if act:
        qconfig = dataclasses.replace(
            qconfig, activation=dataclasses.replace(qconfig.activation, **act))
    if mesh is not None and mesh.model > 1:
        qconfig = dataclasses.replace(
            qconfig, weight=dataclasses.replace(qconfig.weight, axis_name=MODEL_AXIS))
    return qconfig


def entry_device(device) -> torch.device:
    """The device of an entry point: a CUDA device must be present (no
    falling back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to train on the CPU")
    return device


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


# AdamW's constants in the JAX package's optimizer state (f32, as optax
# injects them); eps_root is optax's and 0
_ADAM_CONSTANTS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


def _f32(v) -> np.ndarray:
    return np.asarray(v, np.float32)


def resume_tree(state: TrainState, qat_enabled: bool, epoch: int,
                gather: Optional[Callable] = None) -> Dict[str, Any]:
    """The JAX package's resume tree of a trainer's state: ``params``,
    ``quant_stats`` (``{}`` before QAT), ``opt_state`` as optax's
    clip → inject_hyperparams(adamw) state (torch's ``exp_avg`` /
    ``exp_avg_sq`` / ``step`` as ``mu`` / ``nu`` / ``count``; a state with no
    step yet as count 0 and zero moments), ``step``, ``epoch`` and
    ``qat_enabled``. ``gather`` maps a rank's state dict (and moments, by
    parameter name) to the whole under a model axis
    (``parallel.tensor.gather_params``; every rank of the model group calls
    it)."""
    gather = gather or dict
    sd = gather(state.module.state_dict())
    named = list(state.module.named_parameters())
    adam = state.optimizer.adamw
    slots = [adam.state.get(p) for _, p in named]
    if any(slots):
        if not all(slots):
            raise ValueError("AdamW holds moments for some parameters only")
        counts = {int(s["step"]) for s in slots}
        if len(counts) != 1:
            raise ValueError(f"AdamW's parameters took different step counts: {sorted(counts)}")
        count = counts.pop()
        mu = gather({n: s["exp_avg"] for (n, _), s in zip(named, slots)})
        nu = gather({n: s["exp_avg_sq"] for (n, _), s in zip(named, slots)})
    else:
        count = 0
        mu = gather({n: torch.zeros_like(p) for n, p in named})
        nu = dict(mu)
    hyper = state.optimizer.hyperparams
    hyperparams = {k: _f32(v) for k, v in _ADAM_CONSTANTS.items()}
    hyperparams.update(learning_rate=_f32(hyper["learning_rate"]),
                       weight_decay=_f32(hyper["weight_decay"]))
    count32 = np.asarray(count, np.int32)
    return {
        "params": state_dict_to_params(sd),
        "opt_state": {"0": {}, "1": {
            "count": count32, "hyperparams": hyperparams, "hyperparams_states": {},
            "inner_state": {"0": {"count": count32, "mu": state_dict_to_params(mu),
                                  "nu": state_dict_to_params(nu)},
                            "1": {}, "2": {}}}},
        "quant_stats": buffers_to_quant_stats(sd) if qat_enabled else {},
        "step": int(state.step),
        # epoch / qat_enabled ride inside the msgpack, atomic with the
        # params; the JSON sidecar repeats them for people
        "epoch": int(epoch),
        "qat_enabled": int(qat_enabled),
    }


def restore_resume_tree(state: TrainState, tree: Dict[str, Any], qat_enabled: bool,
                        split: Optional[Callable] = None) -> None:
    """Load a resume tree into ``state`` in place: parameters and (under QAT)
    every observer, strictly; AdamW's moments, step count, learning rate and
    weight decay. A count of 0 leaves AdamW without state, as a fresh
    optimizer. (The file's b1, b2 and eps are AdamW's constants.) ``split``
    maps the whole state dict (and moments) to this rank's shard under a
    model axis (``parallel.tensor.split_params``)."""
    split = split or dict
    sd = params_to_state_dict(tree["params"])
    if qat_enabled:
        sd.update(quant_stats_to_buffers(tree["quant_stats"]))
    sd = split(sd)
    state.module.load_state_dict(sd, strict=True)
    inject = tree["opt_state"]["1"]
    adam_state = inject["inner_state"]["0"]
    set_optimizer_hyperparams(
        state.optimizer,
        learning_rate=float(np.asarray(inject["hyperparams"]["learning_rate"])),
        weight_decay=float(np.asarray(inject["hyperparams"]["weight_decay"])))
    count = int(np.asarray(adam_state["count"]))
    adam = state.optimizer.adamw
    adam.state.clear()
    if count:
        mu = split(params_to_state_dict(adam_state["mu"]))
        nu = split(params_to_state_dict(adam_state["nu"]))
        for name, p in state.module.named_parameters():
            adam.state[p] = {"step": torch.tensor(float(count)),
                             "exp_avg": mu[name].to(p.device, p.dtype),
                             "exp_avg_sq": nu[name].to(p.device, p.dtype)}
    state.step = int(np.asarray(tree["step"]))


def progress(loader, hp: Dict[str, Any], dist, epoch: int, limit_batches: int):
    """``loader``, wrapped in a tqdm bar when ``progress_bar`` is on (rank 0)."""
    if not (hp.get("progress_bar", False) and dist.is_main_process):
        return loader
    from tqdm import tqdm

    return tqdm(loader, total=limit_batches or len(loader), desc=f"epoch {epoch}", leave=False)


@dataclasses.dataclass
class EpochResult:
    epoch: int
    train_loss: float
    qat_acc: float
    quant_acc: float
    qat_enabled: bool
    imgs_per_sec: float
    eval_batches: int = 0


class KDQATTrainer:
    """The KD + QAT engine on this process's device (``device`` is
    required: nothing moves to another device on its own). In a process
    group every rank builds one and enters each of its collectives (DDP's
    wrap and backward, the observers, the epoch's metrics, eval).

    Trial reuse (the search driver): ``seed`` overrides ``hp["seed"]`` (the
    student's init and the loader's shuffle); ``teacher_params`` is an
    earlier trainer's frozen bf16 teacher on the device
    (:attr:`teacher_params`), which this one takes as it is; ``steps`` an
    earlier trainer's :meth:`shared_steps`; ``teacher_logits`` its logit
    cache, a bare array or the ``(logits, filled-rows mask)`` pair, shared
    by reference. A ``student`` built on the ``meta`` device
    (``registry.create_architecture``) is an architecture: its weights are
    drawn from the seed, as without ``student``.

    ``model_parallel`` k > 1 (in a process group whose world k divides):
    the student is split over the model axis of :attr:`mesh` after it is
    built and loaded whole; see the module's docstring."""

    def __init__(
        self,
        hparams: Dict[str, Any],
        *,
        device,
        data: Optional[Dict[str, np.ndarray]] = None,
        run=None,
        student: Optional[ModelBundle] = None,
        teacher: Optional[ModelBundle] = None,
        teacher_params: Optional[torch.nn.Module] = None,
        seed: Optional[int] = None,
        steps: Optional[Dict[str, Callable]] = None,
        teacher_logits=None,
    ):
        self.hp = dict(hparams)
        self.dist = get_dist_info()
        self.mesh = trainer_mesh(self.hp)
        self.run = run if run is not None else NullRun()
        self.device = torch.device(device)
        seed = int(self.hp["seed"] if seed is None else seed)
        image_size = int(self.hp["image_size"])
        num_classes = int(self.hp["num_classes"])
        self.image_size = image_size

        # ---- models: a frozen bf16 teacher, two student configs ----
        gen = torch.Generator().manual_seed(seed)
        family = self.hp.get("student_family", "vit")
        if teacher_params is not None:
            # an earlier trainer's frozen teacher (a search trial): nothing
            # to build, load or cast
            self.teacher = shared_teacher(teacher, teacher_params)
        else:
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
        # the frozen bf16 teacher on the device, for the next trainer's teacher_params
        self.teacher_params = self.teacher.module
        base = with_weights(student, gen) if student is not None else create_student(
            family, num_classes=num_classes, image_size=image_size, generator=gen)
        dtype = torch.bfloat16 if self.hp.get("amp", True) else torch.float32
        qat_dtype = torch.bfloat16 if self.hp.get("qat_amp", False) else torch.float32
        fast = bool(self.hp.get("amp_fast_math", True))
        remat = str(self.hp.get("remat", "none"))
        # JAX's gate (trainer.py: one device, or no model axis): under a model
        # axis the step runs the einsum attention
        attn_kernel = self.mesh.model == 1
        self.student_float_cfg = dataclasses.replace(
            base.cfg, quant=None, qat_wrapper=False, dtype=dtype,
            fast_math=fast and dtype == torch.bfloat16, attn_kernel=attn_kernel, remat=remat)
        self.student_qat_cfg = dataclasses.replace(
            base.cfg, quant=student_qconfig(self.hp, self.mesh), qat_wrapper=True,
            dtype=qat_dtype, fast_math=fast and qat_dtype == torch.bfloat16,
            attn_kernel=attn_kernel, remat=remat,
            fq_in_kernel=bool(self.hp.get("fq_in_kernel", False)))
        self.student_float = self._load(VisionTransformer(self.student_float_cfg), base.module)
        if self.hp.get("student_ckpt"):
            template = state_dict_to_params(self.student_float.state_dict())
            load_jax_variables(self.student_float, load_model_params(
                self.hp["student_ckpt"], self.student_float_cfg, template=template))
            logger.info("loaded student weights from %s", self.hp["student_ckpt"])
        # built and loaded whole (the one-process weights), then split
        shard_module(self.student_float, self.mesh)
        self.student_qat = shard_module(VisionTransformer(self.student_qat_cfg).to(self.device),
                                        self.mesh)

        # ---- optimizer + state ----
        self.state = TrainState(self.student_float,
                                self._optimizer(self.student_float, float(self.hp["lr"])),
                                replica=data_parallel(self.student_float))
        self.qat_enabled = False
        self.loss_hp = loss_hparams(self.hp, self.device)
        self.last_eval_batches = 0

        # ---- steps (shareable across trainers of one architecture: steps=) ----
        self.cache_teacher = bool(self.hp.get("cache_teacher_logits", True))
        step_teacher = None if self.cache_teacher else self.teacher.module
        shared = steps if steps is not None else {}
        self.train_step_float = shared.get("train_float") or make_train_step(
            step_teacher, qat=False, image_size=image_size)
        self.train_step_qat = shared.get("train_qat") or make_train_step(
            step_teacher, qat=True, image_size=image_size)
        # observer_interval k > 1: a second QAT step that fake-quantizes from
        # the frozen statistics, picked on the host (no branch on the device)
        self.observer_interval = max(1, int(self.hp.get("observer_interval", 1)))
        self.train_step_qat_frozen = shared.get("train_qat_frozen") or (make_train_step(
            step_teacher, qat=True, image_size=image_size, observe=False,
        ) if self.observer_interval > 1 else None)
        self._qat_py_step = 0  # QAT steps taken (host-side, for the interval)
        self.eval_step = shared.get("eval") or make_eval_step(image_size)
        self._prep = preprocess_fn(image_size)
        # shareable across search trials (one teacher): a bare [N, C] array
        # (every row filled) or a (logits, filled-rows mask) pair from a lazy
        # cache, shared by reference, so rows one trial fills serve the next
        self._teacher_logits: Optional[np.ndarray] = None
        self._teacher_mask: Optional[np.ndarray] = None
        if teacher_logits is not None:
            if isinstance(teacher_logits, tuple):
                self._teacher_logits, self._teacher_mask = teacher_logits
            else:
                self._teacher_logits = teacher_logits
                self._teacher_mask = np.ones(len(teacher_logits), bool)

        # ---- data ----
        if data is None:
            data, source = load_cifar10(self.hp.get("data_dir", "./data"))
            logger.info("CIFAR-10 source: %s", source)
            if source == "synthetic":
                self.run.set_tag("data_source", "synthetic")
        self.data = data
        # batch_size is per data rank: each its shard of the same shuffle (the
        # model ranks of a data group take the same one)
        self.train_loader = ArrayLoader(data["train_images"], data["train_labels"],
                                        batch_size=int(self.hp["batch_size"]), shuffle=True,
                                        seed=seed, rank=self.mesh.data_index,
                                        world_size=self.mesh.data, drop_last=True)
        self.eval_loader = ArrayLoader(data["test_images"], data["test_labels"],
                                       batch_size=int(self.hp.get("eval_batch_size", 512)),
                                       shuffle=False, drop_last=False)

    # ------------------------------------------------------------------
    def shared_steps(self) -> Dict[str, Callable]:
        """The step functions, for the next trainer of the same architecture
        and teacher (``steps=``): a search trial builds none of its own."""
        return {
            "train_float": self.train_step_float,
            "train_qat": self.train_step_qat,
            "eval": self.eval_step,
            "train_qat_frozen": self.train_step_qat_frozen,
        }

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

    def full_state_dict(self, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """``module``'s whole state dict: under a model axis gathered from the
        model group's shards (every rank of it must call this)."""
        return gather_params(module.state_dict(), module.cfg, self.mesh)

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
                                self.state.step, replica=data_parallel(self.student_qat))
        self.qat_enabled = True
        self._qat_py_step = 0  # the first QAT step observes (the ±inf markers)
        logger.info("QAT enabled (lr -> %.3g)", lr)

    def next_step_fn(self):
        """The step function of the next train step: the float step, or under
        QAT the observing step on the first and every ``observer_interval``-th
        QAT step and the frozen step in between."""
        if not self.qat_enabled:
            return self.train_step_float
        fn = self.train_step_qat
        if self.train_step_qat_frozen is not None:
            if self._qat_py_step % self.observer_interval:
                fn = self.train_step_qat_frozen
            self._qat_py_step += 1
        return fn

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
            planned = (limit_batches * int(self.hp["batch_size"]) * self.mesh.data
                       * max(1, int(self.hp.get("epochs", 1))))
            lazy = planned < len(self.data["train_images"]) // 2
        self._ensure_teacher_logits(lazy=lazy)
        device_metrics = []  # 0-d device tensors: no host sync until the epoch ends
        n_images = 0
        t0 = time.perf_counter()
        loader = progress(self.train_loader, self.hp, self.dist, epoch, limit_batches)
        for i, batch in enumerate(loader):
            if limit_batches and i >= limit_batches:
                break
            dev_batch = {
                "image": self._to_device(batch["image"]),
                "label": torch.from_numpy(batch["label"].astype(np.int64)).to(self.device),
            }
            if self.cache_teacher:
                dev_batch["teacher_logits"] = torch.from_numpy(
                    self._teacher_logits_for(batch)).to(self.device)
            device_metrics.append(self.next_step_fn()(self.state, dev_batch, self.loss_hp))
            n_images += len(batch["label"]) * self.mesh.data
        return epoch_metrics(device_metrics, n_images, t0)

    # ------------------------------------------------------------------
    def _eval_batches(self, limit_batches: int):
        """``(batch, n_real)`` over the test set: in one process the loader
        over the whole set, and ``n_real`` its rows; with data ranks > 1 this
        rank's strided shard ``data_index::data`` (the JAX trainer's
        ``_eval_shard_batches``; the model ranks of a data group take the
        same), every rank padded to the same batch count and batch size
        (label -1: never an argmax), and ``n_real`` the real rows of the
        *global* batch, from the shard arithmetic."""
        world = self.mesh.data
        if world == 1:
            for i, batch in enumerate(self.eval_loader):
                if limit_batches and i >= limit_batches:
                    break
                yield batch, len(batch["label"])
            return
        images, labels = self.data["test_images"], self.data["test_labels"]
        n, bs = len(labels), int(self.hp.get("eval_batch_size", 512))
        shard = np.arange(n)[self.mesh.data_index::world]
        longest = -(-n // world)
        for i in range(-(-longest // bs)):
            if limit_batches and i >= limit_batches:
                break
            sel = shard[i * bs:(i + 1) * bs]
            pad = bs - len(sel)
            batch = {"image": np.concatenate([images[sel], np.zeros((pad,) + images.shape[1:],
                                                                    images.dtype)]),
                     "label": np.concatenate([labels[sel].astype(np.int64),
                                              np.full(pad, -1, np.int64)])}
            real = sum(max(0, min(len_r, (i + 1) * bs) - min(len_r, i * bs))
                       for len_r in ((n - r + world - 1) // world for r in range(world)))
            yield batch, real

    def evaluate(self, limit_batches: int = 0) -> float:
        """Top-1 on the test set with the current (float or fake-quant)
        student, observers frozen; in a world > 1 every rank must call it
        (the counts are summed over the data group: each data group once)."""
        module = self.student_qat if self.qat_enabled else self.student_float
        correct, total = [], 0
        for batch, real in self._eval_batches(limit_batches):
            label = torch.from_numpy(batch["label"].astype(np.int64)).to(self.device)
            correct.append(self.eval_step(module, {"image": self._to_device(batch["image"]),
                                                   "label": label}))
            total += real
        self.last_eval_batches = len(correct)  # this rank's batches
        if not correct:
            return 0.0
        return (float(all_reduce_sum(torch.stack(correct).sum(), self.mesh.data_group))
                / max(total, 1))

    # ------------------------------------------------------------------
    def save_resume_state(self, path: str, epoch: int) -> str:
        """Full-state checkpoint for mid-run resume, in the JAX package's
        tree (:func:`resume_tree`), so either package resumes it. Under a
        model axis every rank must call it (the tree is gathered); rank 0
        alone writes."""
        gather = None
        if self.mesh.model > 1:
            cfg = self.state.module.cfg
            gather = lambda sd: gather_params(sd, cfg, self.mesh)  # noqa: E731
        tree = resume_tree(self.state, self.qat_enabled, epoch, gather=gather)
        if not self.dist.is_main_process:
            return path
        return save_checkpoint(path, tree, {"epoch": epoch, "qat_enabled": self.qat_enabled,
                                            "kind": "resume-state"})

    def load_resume_state(self, path: str) -> int:
        """Restore a resume checkpoint (either package's); returns the epoch
        to continue from. A checkpoint taken under QAT switches to QAT first.
        ``epoch`` / ``qat_enabled`` come from the leaves inside the msgpack;
        the JSON sidecar is a fallback for files without them."""
        raw = load_checkpoint(path)
        meta = load_metadata(path)
        embedded = "epoch" in raw
        qat_enabled = bool(int(np.asarray(raw["qat_enabled"])) if embedded
                           else meta.get("qat_enabled", False))
        epoch = int(np.asarray(raw["epoch"])) if embedded else int(meta.get("epoch", -1))
        if qat_enabled:
            self.enable_qat()
        split = None
        if self.mesh.model > 1:
            cfg = self.state.module.cfg
            split = lambda sd: split_params(sd, cfg, self.mesh)  # noqa: E731
        restore_resume_tree(self.state, raw, self.qat_enabled, split=split)
        return epoch + 1

    def convert_int8(self) -> Dict[str, Any]:
        """Observer folding → the int8 export (CPU tensors); under a model
        axis from the gathered weights, on every rank."""
        if not self.qat_enabled:
            raise RuntimeError("convert requires QAT to have run")
        sd = self.full_state_dict(self.student_qat)
        return convert_vit(sd, sd, self.student_qat_cfg,
                           per_channel_weights=bool(self.hp.get("per_channel_weights", False)))

    def evaluate_int8(self, qparams=None, limit_batches: int = 0) -> float:
        """True-int8 top-1 through the serving preset on this device; in a
        world > 1 each rank serves its data shard and the counts are summed
        over the data group."""
        qparams = qparams if qparams is not None else self.convert_int8()
        pred = Int8Predictor(qparams, self.student_qat_cfg,
                             batch_size=int(self.hp.get("eval_batch_size", 512)),
                             device=self.device)
        correct, total = 0, 0
        for batch, real in self._eval_batches(limit_batches):
            correct += int((pred.predict(batch["image"]) == batch["label"]).sum())
            total += real
        count = all_reduce_sum(torch.tensor(correct, dtype=torch.int64, device=self.device),
                               self.mesh.data_group)
        return int(count) / max(total, 1)


def epoch_metrics(device_metrics, n_images: int, t0: float) -> Dict[str, float]:
    """An epoch's metrics from its steps' 0-d device tensors: each the mean
    over the steps of its mean over the ranks (one all-reduce of the stacked
    steps, then one wait for the device), ``imgs_per_sec`` from the images of
    every rank (``n_images``) over this rank's host clock since ``t0``."""
    if not device_metrics:
        return {"imgs_per_sec": 0.0, "epoch_seconds": time.perf_counter() - t0, "n_batches": 0}
    keys = list(device_metrics[0])
    stacked = all_reduce_mean(torch.stack([torch.stack([m[k] for m in device_metrics])
                                           for k in keys])).cpu()  # waits for the device
    dt = time.perf_counter() - t0
    out = {k: float(v.to(torch.float64).mean()) for k, v in zip(keys, stacked)}
    out["imgs_per_sec"] = n_images / max(dt, 1e-9)
    out["epoch_seconds"] = dt
    out["n_batches"] = len(device_metrics)
    return out


# ---------------------------------------------------------------------------
# the final-training entry point and the CLI
# ---------------------------------------------------------------------------

def log_epoch(dist, epoch: int, tm: Dict[str, float], evals: Dict[str, float]) -> None:
    """Every rank logs its epoch's metrics in full (they are the same on
    every rank: averaged or summed over the ranks) and its own img/s."""
    metrics = {k: tm[k] for k in sorted(tm) if k.startswith("train_")}
    metrics.update(evals)
    logger.info("rank %d/%d epoch %d metrics %s img/s %.1f", dist.rank, dist.world_size, epoch,
                json.dumps(metrics, sort_keys=True), tm["imgs_per_sec"])


def train_main(hp: Dict[str, Any], device="cuda", **trainer_kw) -> Dict[str, Any]:
    """The whole final-training run (the JAX package's ``train_main``):
    ``effective_hparams.yaml``, a tracker run with every hyperparameter as a
    param and the reference's metric names per epoch, the best-model rule
    (``best_qat.msgpack``), the int8 export of the last epoch
    (``best_converted.msgpack``), ``resume_state.msgpack`` every epoch, one
    profiled QAT epoch with ``profile_dir``. Runs on ``device``; a CUDA
    device must be present (pass ``device="cpu"`` for the CPU).
    ``trainer_kw`` (``data``, ``student``, ``teacher``) go to the trainer in
    place of the dataset and the registry's models.

    In a process group every rank calls it (on its own device): every rank
    trains, evaluates and converts; rank 0 alone writes the files (under a
    model axis from tensors every rank gathers), tracks and profiles; the
    ranks meet at ``dataset``, ``epoch`` and ``epoch_end``."""
    device = entry_device(device)
    dist = get_dist_info()
    output_dir = hp["output_dir"]
    sysmetrics = None
    if dist.is_main_process:
        os.makedirs(output_dir, exist_ok=True)
        save_effective_hparams(hp, output_dir)
        tracker = make_tracker(hp["mlflow_uri"], hp["experiment"])
        run = tracker.start_run("final_train")
        run.log_params({k: hp[k] for k in DEFAULT_HPARAMS})
        sysmetrics = enable_system_metrics_logging(run, device=device)
    else:
        run = NullRun()
    barrier("dataset")

    trainer = KDQATTrainer(hp, device=device, run=run, **trainer_kw)
    best = BestCheckpointer(output_dir, "best_qat")
    epochs = int(hp["epochs"])
    qat_start = int(hp["qat_start_epoch"])
    limit_train = int(hp.get("limit_train_batches", 0))
    limit_eval = int(hp.get("limit_eval_batches", 0))
    results = []
    final_quant_acc = 0.0
    start_epoch = 0
    if hp.get("resume"):
        start_epoch = trainer.load_resume_state(hp["resume"])
        logger.info("resumed from %s at epoch %d", hp["resume"], start_epoch)

    profiled = False
    for epoch in range(start_epoch, epochs):
        if epoch >= qat_start:
            trainer.enable_qat()
        if hp.get("profile_dir") and trainer.qat_enabled and not profiled:
            # one QAT epoch under the profiler, cut to bound the trace
            profiled = True
            limit = limit_train or 20
            if not limit_train:
                logger.warning("profile_dir set: the profiled epoch is cut to %d batches", limit)
            profiler = (trace(hp["profile_dir"], device=device) if dist.is_main_process
                        else contextlib.nullcontext())
            with profiler:
                tm = trainer.train_epoch(epoch, limit_batches=limit)
        else:
            tm = trainer.train_epoch(epoch, limit_batches=limit_train)
        barrier("epoch")
        qat_acc = trainer.evaluate(limit_batches=limit_eval)
        quant_acc = qat_acc  # the reference's alias until the last epoch
        if epoch == epochs - 1 and trainer.qat_enabled:
            qparams = trainer.convert_int8()
            quant_acc = trainer.evaluate_int8(qparams, limit_batches=limit_eval)
            final_quant_acc = quant_acc
            if dist.is_main_process:
                save_checkpoint(os.path.join(output_dir, "best_converted.msgpack"), qparams,
                                {"epoch": epoch, "quant_acc": quant_acc,
                                 "format": "int8-weights+qparams"})
        sd = trainer.full_state_dict(trainer.state.module)  # every rank: a gather
        if dist.is_main_process:
            best.maybe_save(
                quant_acc,
                {"params": state_dict_to_params(sd),
                 "quant_stats": buffers_to_quant_stats(sd) if trainer.qat_enabled else {}},
                {"epoch": epoch, "qat_acc": qat_acc, "qat_enabled": trainer.qat_enabled})
            run.log_metrics({
                "train_loss": tm.get("train_loss", 0.0),
                "train_loss_ce": tm.get("train_loss_ce", 0.0),
                "train_loss_kd": tm.get("train_loss_kd", 0.0),
                "qat_acc": qat_acc,
                "quant_acc": quant_acc,
                "imgs_per_sec": tm["imgs_per_sec"],
                "qat_enabled": float(trainer.qat_enabled),
            }, step=epoch)
            logger.info("epoch %d/%d loss %.4f qat_acc %.4f quant_acc %.4f (%.0f img/s)%s",
                        epoch + 1, epochs, tm.get("train_loss", 0.0), qat_acc, quant_acc,
                        tm["imgs_per_sec"], " [QAT]" if trainer.qat_enabled else "")
        log_epoch(dist, epoch, tm, {"qat_acc": qat_acc, "quant_acc": quant_acc})
        if hp.get("save_resume_state", True):  # every rank: a gather; rank 0 writes
            trainer.save_resume_state(os.path.join(output_dir, "resume_state.msgpack"), epoch)
        results.append(EpochResult(epoch, tm.get("train_loss", 0.0), qat_acc, quant_acc,
                                   trainer.qat_enabled, tm["imgs_per_sec"],
                                   eval_batches=trainer.last_eval_batches))
        barrier("epoch_end")

    if dist.is_main_process:
        if sysmetrics is not None:
            sysmetrics.stop()
        run.log_metric("final_quant_acc", final_quant_acc)
        for fname in ("effective_hparams.yaml", "best_qat.msgpack", "best_converted.msgpack"):
            path = os.path.join(output_dir, fname)
            if os.path.isfile(path):
                run.log_artifact(path)
        run.end("FINISHED")
    return {"results": results, "best_acc": best.best_metric,
            "final_quant_acc": final_quant_acc, "output_dir": output_dir}


def main(argv=None, device="cuda") -> None:
    """The training CLI: the JAX package's flags; ``--task detection`` runs
    :func:`train.detect_trainer.detect_train_main`. Under ``torchrun``
    (``python -m torch.distributed.run --nproc_per_node N -m
    qat_vit_tpu_torch.train.trainer ...``) each rank joins the process group
    on its own device (:func:`parallel.setup_distributed`) and leaves it at
    the end."""
    parser = argparse.ArgumentParser(description="KD + QAT final training (PyTorch + CUDA)")
    add_hparam_flags(parser)
    hp = resolve_hparams(parser.parse_args(argv))
    joined = not is_distributed()
    if joined:
        info, device = setup_distributed(device)
    else:
        info = get_dist_info()
    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s rank {info.rank} %(levelname)s %(name)s: %(message)s")
    try:
        if hp.get("task") == "detection":
            from qat_vit_tpu_torch.train.detect_trainer import detect_train_main

            detect_train_main(hp, device=device)
        else:
            train_main(hp, device=device)
    finally:
        if joined:
            cleanup_distributed()


if __name__ == "__main__":  # pragma: no cover
    main()
