"""Quantization-parameter observers as functions on tensors (port of
``qat_vit_tpu/quant/observers.py``).

Same numerics as the JAX package, all in float32:

- the first observation initializes ``min_val``/``max_val`` from the batch,
  later ones take an EMA with ``averaging_constant`` 0.01; ``+inf``/``-inf``
  mark a site that was never observed;
- convert-time qparams (``qparams_affine``/``qparams_symmetric``): the
  observer's ``calculate_qparams`` rules, scale floored at float32 eps;
- train-time qparams (``qparams_fused_*``): the fused QAT kernel's
  ``ChooseQuantizationParams`` rules, scale floored at 6.1e-5.

Rounding is half to even (``torch.round``), as ``jnp.round``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from qat_vit_tpu_torch.parallel.mesh import all_reduce_minmax

FLOAT32_EPS = 1.1920928955078125e-07
SMALL_SCALE_THRESHOLD = 6.0999998822808266e-05
DEFAULT_AVERAGING_CONSTANT = 0.01

Pair = Tuple[torch.Tensor, torch.Tensor]


def _f32(v, like: torch.Tensor = None) -> torch.Tensor:
    device = like.device if like is not None else None
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def update_moving_avg_minmax(
    state_min: torch.Tensor,
    state_max: torch.Tensor,
    x: torch.Tensor,
    averaging_constant: float = DEFAULT_AVERAGING_CONSTANT,
    stride: int = 1,
    axis_name=None,
) -> Pair:
    """One observer step: EMA of the batch min/max, direct init on the first
    call (``state_min`` infinite). Returns the new ``(min, max)``.

    ``stride`` > 1 (an opt-in approximation, ``observer_stride``): observe
    only the contiguous prefix ``x[: max(1, len // stride)]`` of the leading
    axis, the batch axis at every site of the models (of this rank's shard,
    under data parallelism).

    ``axis_name`` (data or tensor parallelism): the shard's min/max are
    reduced over every rank before the EMA, exactly
    (``parallel.mesh.all_reduce_minmax``): to the global batch's, and under
    a model axis to the whole tensor's of a split weight or activation (a
    no-op for a replicated one)."""
    if stride > 1 and x.shape[0] > 1:
        x = x[: max(1, x.shape[0] // stride)]
    # min/max are order statistics: reducing in the input dtype is exact
    batch_min, batch_max = torch.aminmax(x.detach())
    batch_min = batch_min.to(torch.float32)
    batch_max = batch_max.to(torch.float32)
    if axis_name is not None:
        batch_min, batch_max = all_reduce_minmax(batch_min, batch_max)
    c = _f32(averaging_constant, batch_min)
    uninit = torch.isinf(state_min)
    new_min = torch.where(uninit, batch_min, state_min + c * (batch_min - state_min))
    new_max = torch.where(uninit, batch_max, state_max + c * (batch_max - state_max))
    return new_min, new_max


def finite_or_zero(v) -> torch.Tensor:
    """f32 tensor of ``v`` with an unobserved (infinite) bound read as 0."""
    v = _f32(v)
    return torch.where(torch.isinf(v), torch.zeros_like(v), v)


def qparams_affine(min_val, max_val, quant_min: int = 0, quant_max: int = 255) -> Pair:
    """Per-tensor affine scale/zero-point (the convert-time observer rule)."""
    min_neg = torch.clamp(finite_or_zero(min_val), max=0.0)
    max_pos = torch.clamp(finite_or_zero(max_val), min=0.0)
    scale = (max_pos - min_neg) / float(quant_max - quant_min)
    scale = torch.clamp(scale, min=FLOAT32_EPS)
    zero_point = quant_min - torch.round(min_neg / scale)
    zero_point = torch.clamp(zero_point, quant_min, quant_max)
    return scale.to(torch.float32), zero_point.to(torch.float32)


def qparams_symmetric(min_val, max_val, quant_min: int = -128, quant_max: int = 127) -> Pair:
    """Per-tensor symmetric scale (amax / 127.5), zero-point 0."""
    min_neg = torch.clamp(finite_or_zero(min_val), max=0.0)
    max_pos = torch.clamp(finite_or_zero(max_val), min=0.0)
    amax = torch.maximum(-min_neg, max_pos)
    scale = amax / (float(quant_max - quant_min) / 2.0)
    scale = torch.clamp(scale, min=FLOAT32_EPS)
    return scale.to(torch.float32), torch.zeros_like(scale)


def qparams_fused_affine(min_val, max_val, quant_min: int = 0, quant_max: int = 255) -> Pair:
    """Affine qparams as torch's fused QAT kernel computes them: zero-point
    from the end with the smaller nudging error, chosen from the un-floored
    proportions; scale floored at 6.1e-5 (0.1 for a zero range)."""
    min_neg = torch.clamp(finite_or_zero(min_val), max=0.0)
    max_pos = torch.clamp(finite_or_zero(max_val), min=0.0)
    org_scale = (max_pos - min_neg) / float(quant_max - quant_min)
    zero_range = org_scale == 0.0
    safe = torch.where(zero_range, torch.ones_like(org_scale), org_scale)
    rmin = min_neg / safe
    rmax = max_pos / safe
    zp_from_min = quant_min - rmin
    zp_from_max = quant_max - rmax
    err_min = abs(float(quant_min)) - torch.abs(rmin)
    err_max = abs(float(quant_max)) - torch.abs(rmax)
    zero_point = torch.where(err_min < err_max, zp_from_min, zp_from_max)
    zero_point = torch.clamp(torch.round(zero_point), quant_min, quant_max)
    scale = torch.where(
        zero_range, _f32(0.1, org_scale), torch.clamp(org_scale, min=SMALL_SCALE_THRESHOLD)
    )
    return scale.to(torch.float32), zero_point.to(torch.float32)


def qparams_fused_symmetric(min_val, max_val, quant_min: int = -128, quant_max: int = 127) -> Pair:
    """Symmetric qparams as torch's fused QAT kernel computes them:
    ``max(-min/128, max/127)`` when the range straddles zero, the affine
    rule when it is one-sided."""
    min_val = finite_or_zero(min_val)
    max_val = finite_or_zero(max_val)
    both_signs = (min_val < 0.0) & (max_val > 0.0)
    sym_qmin = -((quant_max - quant_min) // 2 + 1)
    sym_qmax = (quant_max - quant_min) // 2
    scale_sym = torch.maximum(-min_val / -float(sym_qmin), max_val / float(sym_qmax))
    scale_aff, zp_aff = qparams_fused_affine(min_val, max_val, quant_min, quant_max)
    scale = torch.where(
        both_signs, torch.clamp(scale_sym, min=SMALL_SCALE_THRESHOLD), scale_aff
    )
    zero_point = torch.where(both_signs, torch.zeros_like(zp_aff), zp_aff)
    return scale.to(torch.float32), zero_point.to(torch.float32)


def qparams_symmetric_per_channel(
    w: torch.Tensor, axis: int, quant_min: int = -128, quant_max: int = 127
) -> Pair:
    """Per-channel symmetric qparams straight from a weight tensor."""
    reduce_dims = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
    amax = torch.amax(torch.abs(w.to(torch.float32)), dim=reduce_dims)
    scale = torch.clamp(amax / (float(quant_max - quant_min) / 2.0), min=FLOAT32_EPS)
    return scale, torch.zeros_like(scale)
