"""Train and eval steps: KD + (optionally) QAT (port of
``qat_vit_tpu/train/steps.py``).

The reference's hot loop (teacher no-grad forward, student forward,
α·KL·T² + (1−α)·CE, clip 1.0, AdamW) as one closure per phase:

- ``qat=False``: the float student (bf16 under the trainer's defaults);
- ``qat=True``: the fake-quant student, observers updated in the step;
- ``qat=True, observe=False``: the observer-frozen QAT step (the trainer's
  ``observer_interval``): fake-quant from the current statistics, no
  observer write, the optimizer steps all the same. The attention takes
  kernel A without the in-kernel fake-quant, as the JAX module does when it
  does not observe.

Data parallelism (the JAX step's ``shard_map`` over the data axis): in a
process group each rank runs the step on its own batch shard through a
``DistributedDataParallel`` wrapper of the student (:func:`data_parallel`,
``TrainState.replica``), so the gradients are averaged over the ranks during
the backward, before clip → AdamW; the activation observers reduce their
min/max over the ranks themselves (``FakeQuantConfig.axis_name``), which is
why DDP broadcasts no buffers. A QAT step whose activation observers lack
the axis raises in a world > 1 (:func:`check_observer_axis`), as JAX's
does: it would train on per-rank statistics.

Tensor parallelism (a model axis, ``parallel/tensor.py``): the student's
qkv / proj / fc1 / fc2 are split over the ranks of a model group and run
its collectives in the forward and backward; DDP averages over the data
group alone (none with one data rank); the clip sums the squared norms of
the split weights' gradients over the model group and adds the replicated
ones once (:func:`clip_by_global_norm_`); every observer reduces over the
world.

PyTorch runs eagerly, so there is nothing to compile or donate: where the
JAX step returns a new donated state, this one updates in place: the
backward writes ``.grad``, the optimizer rewrites parameters and moments,
and the observers rewrite their buffers. The step returns its metrics as
0-d device tensors and never waits on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from qat_vit_tpu_torch.data.pipeline import preprocess_fn
from qat_vit_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    all_reduce_sum,
    is_distributed,
    world_size,
)
from qat_vit_tpu_torch.quant.modules import FakeQuantizer
from qat_vit_tpu_torch.train.losses import kd_loss, top1_correct


def clip_by_global_norm_(grads, max_norm: float, split=(), group=None) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: every gradient is scaled by
    ``max_norm / ‖g‖`` unless ``‖g‖ < max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Branch-free on the device: no host
    sync. Returns the global norm.

    ``split``: under a model axis, the gradients of this rank's shards of
    the split weights; their squared norm is summed over ``group`` and the
    replicated ``grads`` (the same on every rank of it) count once."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if split:
        sq = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(split))).square()
        norm = torch.sqrt(norm.square() + all_reduce_sum(sq, group))
        grads = list(grads) + list(split)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


class ClipAdamW:
    """clip-by-global-norm → AdamW with torch's defaults (β = (0.9, 0.999),
    eps 1e-8, decoupled weight decay on every parameter): the reference's
    optimizer with its clip(1.0). ``learning_rate`` / ``weight_decay`` are
    set without rebuilding (:func:`set_optimizer_hyperparams`). Parameters
    split over a model axis (marked ``tp_group`` by
    ``parallel.tensor.shard_module``) enter the clip's norm over their
    group."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float, weight_decay: float,
                 grad_clip_norm: float = 1.0):
        self.params = [p for p in params if p.requires_grad]
        self.split = [hasattr(p, "tp_group") for p in self.params]
        self.group = next((p.tp_group for p in self.params if hasattr(p, "tp_group")), None)
        self.max_norm = float(grad_clip_norm)
        # the global gradient norm before the last step's clip (a 0-d device
        # tensor; the gradients averaged over the ranks in a process group)
        self.last_grad_norm: Optional[torch.Tensor] = None
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)

    @property
    def hyperparams(self) -> Dict[str, float]:
        group = self.adamw.param_groups[0]
        return {"learning_rate": group["lr"], "weight_decay": group["weight_decay"]}

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        whole = [p.grad for p, s in zip(self.params, self.split) if p.grad is not None and not s]
        split = [p.grad for p, s in zip(self.params, self.split) if p.grad is not None and s]
        if whole or split:
            self.last_grad_norm = clip_by_global_norm_(whole, self.max_norm, split, self.group)
        self.adamw.step()


def make_optimizer(params: Iterable[nn.Parameter], lr: float, weight_decay: float,
                   grad_clip_norm: float = 1.0) -> ClipAdamW:
    """Fresh moments over ``params``: clip(``grad_clip_norm``) → AdamW."""
    return ClipAdamW(params, lr, weight_decay, grad_clip_norm)


_HYPERPARAM_KEYS = {"learning_rate": "lr", "weight_decay": "weight_decay"}


def set_optimizer_hyperparams(optimizer: ClipAdamW, **values) -> ClipAdamW:
    """Overwrite ``learning_rate`` / ``weight_decay`` in place."""
    for k, v in values.items():
        if k not in _HYPERPARAM_KEYS:
            raise KeyError(f"unknown optimizer hyperparam {k!r}; have {sorted(_HYPERPARAM_KEYS)}")
        for group in optimizer.adamw.param_groups:
            group[_HYPERPARAM_KEYS[k]] = float(v)
    return optimizer


@dataclasses.dataclass
class TrainState:
    """The student module (parameters and observer buffers), its optimizer
    and the step counter; all three change in place. ``replica`` is the
    module's ``DistributedDataParallel`` wrapper in a process group, the
    module the step calls; ``module`` stays the bare one (its state dict,
    the optimizer's parameters and every file carry no ``module.`` prefix)."""

    module: nn.Module
    optimizer: ClipAdamW
    step: int = 0
    replica: Optional[nn.Module] = None

    @property
    def net(self) -> nn.Module:
        """The module a train step calls."""
        return self.replica if self.replica is not None else self.module


def data_parallel(module: nn.Module) -> Optional[nn.Module]:
    """``module`` wrapped in ``DistributedDataParallel`` when this process
    is in a process group (None otherwise): gradients averaged over the
    ranks in the backward; no buffer broadcast (the observers reduce their
    own statistics, and rank 0's must not overwrite them). The wrapper
    syncs the parameters from rank 0 once, here; every rank must call it.

    A module split over a model axis (``module.mesh``) averages over its
    data group alone, the ranks that hold the same shard (over the world,
    DDP would broadcast rank 0's shard into the other model ranks); with one
    data rank there is nothing to average and no wrapper."""
    if not is_distributed():
        return None
    from torch.nn.parallel import DistributedDataParallel

    mesh = getattr(module, "mesh", None)
    group = None
    if mesh is not None and mesh.model > 1:
        if mesh.data == 1:
            return None
        group = mesh.data_group
    device = next(module.parameters()).device
    return DistributedDataParallel(
        module, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False, process_group=group)


def check_observer_axis(module: nn.Module) -> None:
    """Raise when a QAT step in a world > 1 would observe per-rank
    statistics: every activation observer must reduce over ``DATA_AXIS``
    (JAX's guard in ``make_train_step(mesh=...)``) and, under a model axis
    (``module.mesh``), every weight observer over ``MODEL_AXIS`` (a split
    weight's shards make the whole tensor)."""
    if world_size() == 1:
        return
    quant = getattr(getattr(module, "cfg", None), "quant", None)
    axis = quant.activation.axis_name if quant is not None else None
    if axis != DATA_AXIS:
        raise ValueError(
            f"QAT train step in a world of {world_size()} ranks, but the activation observers "
            f"have axis_name={axis!r}; set FakeQuantConfig.axis_name={DATA_AXIS!r} or the "
            "observer statistics lose their global-batch semantics")
    mesh = getattr(module, "mesh", None)
    if mesh is not None and mesh.model > 1 and quant.weight.axis_name != MODEL_AXIS:
        raise ValueError(
            f"QAT train step under a model axis of {mesh.model}, but the weight observers have "
            f"axis_name={quant.weight.axis_name!r}; set FakeQuantConfig.axis_name="
            f"{MODEL_AXIS!r} or a split weight is quantized with its shard's statistics")


def loss_hparams(hparams: Dict, device=None) -> Dict[str, torch.Tensor]:
    """Loss hyperparameters as 0-d f32 device tensors, passed into the step."""
    return {
        name: torch.tensor(float(hparams[key]), dtype=torch.float32, device=device)
        for name, key in (("alpha", "kd_alpha"), ("temperature", "kd_temperature"),
                          ("label_smoothing", "label_smoothing"))
    }


def make_train_step(teacher: Optional[nn.Module], *, qat: bool, image_size: int,
                    observe: bool = True) -> Callable:
    """The KD(+QAT) train step ``step(state, batch, loss_hp) -> metrics``.

    ``batch`` holds device tensors: ``image`` uint8 ``[B, h, w, 3]``,
    ``label`` int64 and, for the cached-teacher variant (``teacher=None``),
    ``teacher_logits``; otherwise the frozen ``teacher`` runs on every step
    under ``no_grad``. Preprocessing runs inside the step, on the device.
    ``observe=False`` with ``qat`` fake-quantizes from the frozen statistics.
    In a process group the batch is this rank's shard and the state's
    ``replica`` averages the gradients; the metrics stay this rank's (the
    trainer averages them once an epoch).
    """
    prep = preprocess_fn(image_size)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             loss_hp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if qat:
            check_observer_axis(state.module)
        x = prep(batch["image"])
        labels = batch["label"]
        if teacher is None:
            t_logits = batch["teacher_logits"].to(torch.float32)
        else:
            with torch.no_grad():
                t_logits = teacher(x, observe=False).to(torch.float32)
        s_logits = state.net(x, observe=qat and observe)
        loss, metrics = kd_loss(s_logits, t_logits, labels, alpha=loss_hp["alpha"],
                                temperature=loss_hp["temperature"],
                                label_smoothing=loss_hp["label_smoothing"])
        metrics["train_acc"] = top1_correct(s_logits, labels) / labels.shape[0]
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_step(image_size: int) -> Callable:
    """``step(module, batch) -> #top-1-correct`` (a device tensor), with
    the observers frozen."""
    prep = preprocess_fn(image_size)

    @torch.no_grad()
    def step(module: nn.Module, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return top1_correct(module(prep(batch["image"]), observe=False), batch["label"])

    return step


def init_quant_stats(module: nn.Module) -> nn.Module:
    """Fresh observers for the QAT phase switch: every ``min_val`` at +inf
    and ``max_val`` at -inf, in place; parameters untouched."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, FakeQuantizer):
                m.min_val.fill_(float("inf"))
                m.max_val.fill_(float("-inf"))
    return module
