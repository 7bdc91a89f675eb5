"""Train and eval steps: KD + (optionally) QAT (port of
``qat_vit_tpu/train/steps.py``).

The reference's hot loop (teacher no-grad forward, student forward,
α·KL·T² + (1−α)·CE, clip 1.0, AdamW) as one closure per phase:

- ``qat=False``: the float student (bf16 under the trainer's defaults);
- ``qat=True``: the fake-quant student, observers updated every step.

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
from qat_vit_tpu_torch.quant.modules import FakeQuantizer
from qat_vit_tpu_torch.train.losses import kd_loss, top1_correct


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: every gradient is scaled by
    ``max_norm / ‖g‖`` unless ``‖g‖ < max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Branch-free on the device: no host
    sync. Returns the global norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


class ClipAdamW:
    """clip-by-global-norm → AdamW with torch's defaults (β = (0.9, 0.999),
    eps 1e-8, decoupled weight decay on every parameter): the reference's
    optimizer with its clip(1.0). ``learning_rate`` / ``weight_decay`` are
    set without rebuilding (:func:`set_optimizer_hyperparams`)."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float, weight_decay: float,
                 grad_clip_norm: float = 1.0):
        self.params = [p for p in params if p.requires_grad]
        self.max_norm = float(grad_clip_norm)
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)

    @property
    def hyperparams(self) -> Dict[str, float]:
        group = self.adamw.param_groups[0]
        return {"learning_rate": group["lr"], "weight_decay": group["weight_decay"]}

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if grads:
            clip_by_global_norm_(grads, self.max_norm)
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
    and the step counter; all three change in place."""

    module: nn.Module
    optimizer: ClipAdamW
    step: int = 0


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
    """
    if qat and not observe:
        raise NotImplementedError(
            "the observer-frozen QAT step (observer_interval > 1) is not ported: "
            "ROADMAP.md Queue 1, item 6"
        )
    prep = preprocess_fn(image_size)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             loss_hp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        x = prep(batch["image"])
        labels = batch["label"]
        if teacher is None:
            t_logits = batch["teacher_logits"].to(torch.float32)
        else:
            with torch.no_grad():
                t_logits = teacher(x, observe=False).to(torch.float32)
        s_logits = state.module(x, observe=qat)
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
