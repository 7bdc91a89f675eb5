"""Quantization configuration (port of ``qat_vit_tpu/quant/qconfig.py``).

One hashable dataclass per fake-quant site and a pair of them per model, as
the JAX package declares them. The torch.ao ``QConfig`` is not used: its
observers differ (no identity-until-observed, scale 1 before calibration).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from qat_vit_tpu_torch.quant.observers import DEFAULT_AVERAGING_CONSTANT


@dataclasses.dataclass(frozen=True)
class FakeQuantConfig:
    """Settings for one fake-quant site (an activation or weight observer)."""

    quant_min: int
    quant_max: int
    symmetric: bool
    averaging_constant: float = DEFAULT_AVERAGING_CONSTANT
    # reduce the batch min/max over every rank before the EMA
    # (``parallel.mesh.all_reduce_minmax``, JAX's pmin/pmax): the trainer
    # sets DATA_AXIS on activation observers when it runs in a process group,
    # and MODEL_AXIS on weight observers under a model axis (a split weight's
    # shards make the whole tensor; a replicated one is the same on every
    # rank); None for one process and for weight observers under data
    # parallelism alone
    axis_name: Optional[str] = None
    # observe only the first 1/observe_stride of the leading (batch) axis, a
    # contiguous prefix (:func:`observers.update_moving_avg_minmax`); the
    # trainer sets it on activation observers from ``observer_stride``
    observe_stride: int = 1


@dataclasses.dataclass(frozen=True)
class QConfig:
    """Activation + weight fake-quant settings."""

    activation: FakeQuantConfig
    weight: FakeQuantConfig
    backend: str = "qnnpack"


def default_qat_qconfig(backend: str = "qnnpack") -> QConfig:
    """activation: per-tensor affine uint8 [0, 255] ([0, 127] for fbgemm's
    reduced range), EMA min/max c=0.01; weight: per-tensor symmetric int8
    [-128, 127], EMA min/max c=0.01."""
    if backend == "qnnpack":
        act = FakeQuantConfig(quant_min=0, quant_max=255, symmetric=False)
    elif backend == "fbgemm":
        act = FakeQuantConfig(quant_min=0, quant_max=127, symmetric=False)
    else:
        raise ValueError(f"unknown QAT backend: {backend!r}")
    wt = FakeQuantConfig(quant_min=-128, quant_max=127, symmetric=True)
    return QConfig(activation=act, weight=wt, backend=backend)

