"""Detection KD train and eval steps: distil a teacher detector into a
QAT-armed pruned student (port of ``qat_vit_tpu/train/detect_steps.py``).

The detection counterpart of the classification steps (``train/steps.py``)
distils the *outputs* of the teacher's detection forward:

- per-query class logits: softmax-KL over the patch axis per (image, query),
  temperature-scaled like the classification KD loss;
- boxes: L1 on the sigmoid-squashed (cx, cy, w, h) predictions;
- objectness: BCE of the student's logits against the teacher's
  probabilities.

The tower trains under the classification fake-quant machinery (observers
updated in the step, the phase switch, convert through
``serve/int8_detect.py``); the heads stay float. As in ``train/steps.py``
the step updates the module, the optimizer and the observers in place and
returns its metrics as 0-d device tensors. Data parallelism as there: in a
process group the state's ``replica`` (DDP) averages the gradients over the
ranks, the activation observers reduce over them, and a QAT step without
the observers' axis raises in a world > 1.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from qat_vit_tpu_torch.data.pipeline import preprocess_fn
from qat_vit_tpu_torch.train.steps import TrainState, check_observer_axis


def detection_kd_loss(
    student_out: Dict[str, torch.Tensor],
    teacher_out: Dict[str, torch.Tensor],
    *,
    temperature,
    box_weight,
    obj_weight,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The distillation objective over detection outputs (f32); the weights
    may be 0-d tensors or numbers."""
    f32 = torch.float32
    t = torch.as_tensor(temperature, dtype=f32)
    # class KD: a distribution over patches per (image, query), softened by T
    s_log = F.log_softmax(student_out["logits"].to(f32).transpose(1, 2) / t, dim=-1)
    t_log = F.log_softmax(teacher_out["logits"].to(f32).transpose(1, 2) / t, dim=-1)
    kl = (torch.exp(t_log) * (t_log - s_log)).sum(dim=-1)  # [B, Q]
    cls_loss = kl.mean() * t * t
    box_loss = (student_out["pred_boxes"].to(f32) - teacher_out["pred_boxes"].to(f32)).abs().mean()
    t_obj = torch.sigmoid(teacher_out["objectness_logits"].to(f32))
    s_obj = student_out["objectness_logits"].to(f32)
    # BCE-with-logits against soft teacher targets, in the JAX form
    obj_loss = (torch.clamp_min(s_obj, 0.0) - s_obj * t_obj
                + torch.log1p(torch.exp(-s_obj.abs()))).mean()
    loss = cls_loss + box_weight * box_loss + obj_weight * obj_loss
    return loss, {"train_loss": loss, "train_loss_kd": cls_loss, "train_loss_box": box_loss,
                  "train_loss_obj": obj_loss}


def detect_loss_hparams(hparams: Dict, device=None) -> Dict[str, torch.Tensor]:
    """Loss hyperparameters as 0-d f32 device tensors, passed into the step."""
    values = {"temperature": hparams["kd_temperature"],
              "box_weight": hparams.get("det_box_weight", 1.0),
              "obj_weight": hparams.get("det_obj_weight", 0.25)}
    return {k: torch.tensor(float(v), dtype=torch.float32, device=device) for k, v in values.items()}


def make_detect_train_step(teacher: Optional[nn.Module], *, qat: bool, image_size: int,
                           observe: bool = True) -> Callable:
    """The detection KD(+QAT) train step ``step(state, batch, loss_hp) ->
    metrics``.

    ``batch`` holds device tensors: ``image`` uint8 ``[B, h, w, 3]``,
    ``query_embeds`` ``[B, Q, text_dim]`` and, for the cached-teacher
    variant (``teacher=None``), the frozen teacher's ``t_logits [B, P, Q]``,
    ``t_boxes [B, P, 4]`` and ``t_obj [B, P]``; otherwise the ``teacher``
    detector runs on every step under ``no_grad``. ``observe=False`` with
    ``qat`` is the observer-frozen step: fake-quant from the current
    statistics, no observer write."""
    prep = preprocess_fn(image_size)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             loss_hp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if qat:
            check_observer_axis(state.module)
        x = prep(batch["image"])
        q = batch["query_embeds"]
        if teacher is None:
            t_out = {"logits": batch["t_logits"], "pred_boxes": batch["t_boxes"],
                     "objectness_logits": batch["t_obj"]}
        else:
            with torch.no_grad():
                t_out = teacher(x, q, observe=False)
        s_out = state.net(x, q, observe=qat and observe)
        loss, metrics = detection_kd_loss(s_out, t_out, temperature=loss_hp["temperature"],
                                          box_weight=loss_hp["box_weight"],
                                          obj_weight=loss_hp["obj_weight"])
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


def detection_agreement(out: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                        valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Sums over the images of one batch, weighted by ``valid`` (``[B]``,
    0 for the rows that pad a short batch): the mean |Δbox| per image
    (``box_err_sum``), the top-box agreement per image (``agree_sum``: the
    argmax patch per query by class logit, ``out`` against ``ref``) and
    ``n``, all 0-d device tensors."""
    box_err = (valid * (out["pred_boxes"] - ref["pred_boxes"]).abs().mean(dim=(1, 2))).sum()
    same = out["logits"].argmax(dim=1) == ref["logits"].argmax(dim=1)  # [B, Q]
    agree = (valid * same.to(torch.float32).mean(dim=-1)).sum()
    return {"box_err_sum": box_err, "agree_sum": agree, "n": valid.sum()}


def make_detect_eval_step(teacher: nn.Module, *, image_size: int) -> Callable:
    """``step(module, batch) -> sums``: :func:`detection_agreement` of the
    student against the frozen teacher on one batch, observers frozen;
    ``valid`` in the batch is optional."""
    prep = preprocess_fn(image_size)

    @torch.no_grad()
    def step(module: nn.Module, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        x = prep(batch["image"])
        q = batch["query_embeds"]
        v = batch.get("valid")
        v = torch.ones(x.shape[0], device=x.device) if v is None else v.to(torch.float32)
        return detection_agreement(module(x, q, observe=False), teacher(x, q, observe=False), v)

    return step
