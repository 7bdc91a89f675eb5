"""Training losses with torch's reduction conventions, all in f32 (port of
``qat_vit_tpu/train/losses.py``)::

    loss = alpha * KLDiv(log_softmax(s/T), softmax(t/T), 'batchmean') * T^2
         + (1 - alpha) * CrossEntropy(s, y, label_smoothing=ls)

The hyperparameters may be 0-d device tensors, so a step never reads them
on the host.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, label_smoothing=0.0) -> torch.Tensor:
    """``F.cross_entropy(..., label_smoothing=ls)``: batch mean of
    ``-(1-ls)·log p_y - (ls/K)·Σ_c log p_c``, in the JAX package's form."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ls = _f32(label_smoothing, logp)
    nll = -logp.gather(-1, labels.to(torch.int64)[:, None])[:, 0]
    smooth = -logp.mean(dim=-1)
    return ((1.0 - ls) * nll + ls * smooth).mean()


def kd_kl_divergence(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                     temperature) -> torch.Tensor:
    """``KLDivLoss(reduction='batchmean')(log_softmax(s/T), softmax(t/T))·T²``."""
    t = _f32(temperature, student_logits)
    s_logp = F.log_softmax(student_logits.to(torch.float32) / t, dim=-1)
    t_logp = F.log_softmax(teacher_logits.to(torch.float32) / t, dim=-1)
    kl = (torch.exp(t_logp) * (t_logp - s_logp)).sum(dim=-1)
    return kl.mean() * t * t


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor, labels: torch.Tensor, *,
            alpha, temperature, label_smoothing) -> Tuple[torch.Tensor, dict]:
    """The distillation objective → ``(loss, components)`` under the
    reference's metric names."""
    alpha = _f32(alpha, student_logits)
    ce = cross_entropy(student_logits, labels, label_smoothing)
    kd = kd_kl_divergence(student_logits, teacher_logits, temperature)
    loss = alpha * kd + (1.0 - alpha) * ce
    return loss, {"train_loss": loss, "train_loss_ce": ce, "train_loss_kd": kd}


def top1_correct(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Count of top-1 correct predictions in the batch (a device tensor)."""
    return (logits.argmax(dim=-1) == labels).sum()
