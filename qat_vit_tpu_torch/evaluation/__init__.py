"""Evaluation: the test-set evaluator and the multi-checkpoint comparator
(port of ``qat_vit_tpu/evaluation``)."""

from qat_vit_tpu_torch.evaluation.comparator import (
    CompareItem,
    compare_checkpoints,
    format_table,
)
from qat_vit_tpu_torch.evaluation.evaluator import (
    build_cifar10_loader,
    evaluate_checkpoint,
    evaluate_model,
)

__all__ = [
    "CompareItem",
    "build_cifar10_loader",
    "compare_checkpoints",
    "evaluate_checkpoint",
    "evaluate_model",
    "format_table",
]
