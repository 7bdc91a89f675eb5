"""Fake-quantize (quantize → dequantize), forward only (port of
``qat_vit_tpu/quant/fake_quant.py``).

Calibration needs only the forward. The straight-through-estimator
``torch.autograd.Function`` comes with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from qat_vit_tpu_torch.quant.observers import (
    DEFAULT_AVERAGING_CONSTANT,
    qparams_fused_affine,
    qparams_fused_symmetric,
    update_moving_avg_minmax,
)


def fake_quantize(
    x: torch.Tensor, scale, zero_point, quant_min: int, quant_max: int
) -> torch.Tensor:
    """``(clamp(round(x / scale + zp), qmin, qmax) - zp) * scale`` in f32."""
    q = torch.round(x.to(torch.float32) / scale + zero_point)
    out = (torch.clamp(q, quant_min, quant_max) - zero_point) * scale
    return out.to(x.dtype)


def fused_moving_avg_obs_fake_quant(
    x: torch.Tensor,
    min_val: torch.Tensor,
    max_val: torch.Tensor,
    *,
    symmetric: bool,
    quant_min: int,
    quant_max: int,
    observe: bool,
    averaging_constant: float = DEFAULT_AVERAGING_CONSTANT,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ``FusedMovingAvgObsFakeQuantize`` step: observe (when
    ``observe``), derive train-time qparams from the updated state, then
    fake-quantize. Returns ``(y, new_min, new_max)``.

    Identity until observed: with ``observe=False`` a site whose min is
    still infinite passes ``x`` through unchanged."""
    if observe:
        new_min, new_max = update_moving_avg_minmax(min_val, max_val, x, averaging_constant)
    else:
        new_min, new_max = min_val, max_val
    if symmetric:
        scale, zero_point = qparams_fused_symmetric(new_min, new_max, quant_min, quant_max)
    else:
        scale, zero_point = qparams_fused_affine(new_min, new_max, quant_min, quant_max)
    y = fake_quantize(x, scale, zero_point, quant_min, quant_max)
    if not observe:
        y = torch.where(torch.isinf(new_min), x, y)
    return y, new_min, new_max


def quantize_to_int(
    x: torch.Tensor, scale, zero_point, quant_min: int, quant_max: int,
    dtype=torch.int8,
) -> torch.Tensor:
    """Real quantization, no dequantize (convert and the int8 path)."""
    q = torch.round(x.to(torch.float32) / scale + zero_point)
    return torch.clamp(q, quant_min, quant_max).to(dtype)


def dequantize(q: torch.Tensor, scale, zero_point, dtype=torch.float32) -> torch.Tensor:
    return ((q.to(torch.float32) - zero_point) * scale).to(dtype)
