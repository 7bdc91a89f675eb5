"""Multi-checkpoint comparison: a fixed-width top-1 report (port of
``qat_vit_tpu/evaluation/comparator.py``, the reference's
``src/evaluation/comparator.py:17-77``).

``CompareItem`` rows → :func:`compare_checkpoints` → :func:`format_table`.
The reference's default rows (the teacher when given, ``student_qat`` =
best_qat with the QAT wrapper, ``student_quant`` = best_converted as an
int8 export) are kept. A row that fails is recorded with its error and the
report goes on, as in the JAX package. :func:`main` is the CLI, ``python -m
qat_vit_tpu_torch.evaluation.comparator``; it runs on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import List, Optional

from qat_vit_tpu_torch.evaluation.evaluator import evaluate_checkpoint

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CompareItem:
    """One comparison row (reference CompareItem, comparator.py:17-22)."""

    name: str
    model: str
    ckpt: Optional[str] = None
    qat_wrapper: bool = False
    int8: bool = False
    # the backend the checkpoint was trained with (activation ranges differ:
    # qnnpack [0, 255], fbgemm [0, 127])
    qat_backend: str = "qnnpack"


def compare_checkpoints(
    items: List[CompareItem],
    data_dir: str = "./data",
    batch_size: int = 512,
    limit_batches: int = 0,
    device="cuda",
) -> List[dict]:
    """Evaluate every row (reference compare_checkpoints, :25-42); a row's
    failure is recorded in its ``error`` rather than ending the report."""
    results = []
    for item in items:
        try:
            acc = evaluate_checkpoint(
                item.model, item.ckpt, qat_wrapper=item.qat_wrapper, int8=item.int8,
                data_dir=data_dir, batch_size=batch_size, limit_batches=limit_batches,
                qat_backend=item.qat_backend, device=device,
            )
            results.append({"name": item.name, "acc": acc, "error": None})
        except Exception as e:  # per-row tolerance
            logger.warning("row %s failed: %s", item.name, e)
            results.append({"name": item.name, "acc": None, "error": str(e)})
    return results


def format_table(results: List[dict]) -> str:
    """Fixed-width report (reference :73-77)."""
    lines = [f"{'model':<24} {'top-1':>8}", "-" * 34]
    for r in results:
        acc = f"{r['acc']*100:7.2f}%" if r["acc"] is not None else "  ERROR "
        lines.append(f"{r['name']:<24} {acc:>8}")
    return "\n".join(lines)


def main(argv=None, device="cuda") -> None:
    """Reference CLI defaults (comparator.py:45-77)."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="compare checkpoints on CIFAR-10")
    p.add_argument("--teacher-ckpt", default=None)
    p.add_argument("--model", default="vit_small_patch16_224_student",
                   help="student architecture (registry name)")
    p.add_argument("--qat-ckpt", default="qat_output/best_qat.msgpack")
    p.add_argument("--quant-ckpt", default="qat_output/best_converted.msgpack")
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--limit-batches", type=int, default=0)
    p.add_argument("--qat-backend", default="qnnpack", choices=("qnnpack", "fbgemm"),
                   help="backend the checkpoints were trained with")
    args = p.parse_args(argv)

    items = []
    if args.teacher_ckpt:
        items.append(CompareItem("teacher", "vit_base_patch16_224_teacher", args.teacher_ckpt))
    items.append(CompareItem("student_qat", args.model, args.qat_ckpt, qat_wrapper=True,
                             qat_backend=args.qat_backend))
    items.append(CompareItem("student_quant", args.model, args.quant_ckpt, int8=True,
                             qat_backend=args.qat_backend))
    results = compare_checkpoints(items, args.data_dir, args.batch_size, args.limit_batches,
                                  device=device)
    print(format_table(results))


if __name__ == "__main__":  # pragma: no cover
    main()
