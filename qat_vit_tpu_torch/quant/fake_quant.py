"""Fake-quantize (quantize → dequantize) with a straight-through-estimator
backward (port of ``qat_vit_tpu/quant/fake_quant.py``).

Forward, in f32, cast back to the input dtype::

    q   = round(x / scale + zero_point)          # round half to even
    out = (clamp(q, qmin, qmax) - zero_point) * scale

Backward (STE): the gradient passes where ``qmin <= q <= qmax`` and is zero
elsewhere, torch's ``fake_quantize_per_tensor_affine_cachemask`` rule.
``scale`` and ``zero_point`` come from observers and get no gradient.
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


def fq_grid(x: torch.Tensor, scale, zero_point) -> torch.Tensor:
    """The unclipped grid value ``round(x / scale + zp)`` in f32."""
    return torch.round(x.to(torch.float32) / scale + zero_point)


def fake_quantize_values(x: torch.Tensor, scale, zero_point, quant_min: int,
                         quant_max: int) -> torch.Tensor:
    """The forward alone, outside autograd (the attention kernels' plain
    versions apply it to the packed qkv)."""
    q = torch.clamp(fq_grid(x, scale, zero_point), quant_min, quant_max)
    return ((q - zero_point) * scale).to(x.dtype)


def ste_mask(x: torch.Tensor, scale, zero_point, quant_min: int, quant_max: int) -> torch.Tensor:
    """Where the straight-through estimator passes the gradient."""
    q = fq_grid(x, scale, zero_point)
    return (q >= quant_min) & (q <= quant_max)


class _FakeQuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zero_point, quant_min, quant_max):
        q = fq_grid(x, scale, zero_point)
        ctx.save_for_backward((q >= quant_min) & (q <= quant_max))
        return ((torch.clamp(q, quant_min, quant_max) - zero_point) * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, torch.zeros_like(g)), None, None, None, None


def fake_quantize(
    x: torch.Tensor, scale, zero_point, quant_min: int, quant_max: int
) -> torch.Tensor:
    """``(clamp(round(x / scale + zp), qmin, qmax) - zp) * scale`` in f32,
    cast back to ``x.dtype``; STE backward."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return fake_quantize_values(x, scale, zero_point, quant_min, quant_max)
    return _FakeQuantizeSTE.apply(x, scale, zero_point, quant_min, quant_max)


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
    stride: int = 1,
    axis_name=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ``FusedMovingAvgObsFakeQuantize`` step: observe (when
    ``observe``), derive train-time qparams from the updated state, then
    fake-quantize. Returns ``(y, new_min, new_max)``.

    Identity until observed: with ``observe=False`` a site whose min is
    still infinite passes ``x`` through unchanged."""
    new_min, new_max, scale, zero_point = observe_and_qparams(
        x, min_val, max_val, symmetric=symmetric, quant_min=quant_min, quant_max=quant_max,
        observe=observe, averaging_constant=averaging_constant, stride=stride,
        axis_name=axis_name)
    y = fake_quantize(x, scale, zero_point, quant_min, quant_max)
    if not observe:
        y = torch.where(torch.isinf(new_min), x, y)
    return y, new_min, new_max


def observe_and_qparams(
    x: torch.Tensor,
    min_val: torch.Tensor,
    max_val: torch.Tensor,
    *,
    symmetric: bool,
    quant_min: int,
    quant_max: int,
    observe: bool,
    averaging_constant: float = DEFAULT_AVERAGING_CONSTANT,
    stride: int = 1,
    axis_name=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Observer update + qparams WITHOUT applying the fake-quant: exactly the
    ``(scale, zero_point)`` :func:`fused_moving_avg_obs_fake_quant` would
    use, for a kernel that applies the fake-quant itself
    (``ops/flash_attention_train.attention_train_fq``). Returns
    ``(new_min, new_max, scale, zero_point)``, all device tensors."""
    with torch.no_grad():
        if observe:
            new_min, new_max = update_moving_avg_minmax(min_val, max_val, x, averaging_constant,
                                                        stride, axis_name)
        else:
            new_min, new_max = min_val, max_val
        qparams = qparams_fused_symmetric if symmetric else qparams_fused_affine
        scale, zero_point = qparams(new_min, new_max, quant_min, quant_max)
    return new_min, new_max, scale, zero_point


def quantize_to_int(
    x: torch.Tensor, scale, zero_point, quant_min: int, quant_max: int,
    dtype=torch.int8,
) -> torch.Tensor:
    """Real quantization, no dequantize (convert and the int8 path)."""
    q = torch.round(x.to(torch.float32) / scale + zero_point)
    return torch.clamp(q, quant_min, quant_max).to(dtype)


def dequantize(q: torch.Tensor, scale, zero_point, dtype=torch.float32) -> torch.Tensor:
    return ((q.to(torch.float32) - zero_point) * scale).to(dtype)
