"""Convert: fold observer statistics into a true-int8 export (port of
``qat_vit_tpu/quant/convert.py``).

Convert-time qparams use the observer formulas (symmetric ``amax/127.5``),
not the fused train-time kernel's, as torch and the JAX package do.

Dense weights come in as ``[K, N]`` (the JAX layout, ``nn.Linear.weight.T``)
and leave as ``w_int8 [K, N]`` with ``w_colsum [N]`` int32, so the export
has the JAX package's layout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from qat_vit_tpu_torch.quant.fake_quant import quantize_to_int
from qat_vit_tpu_torch.quant.observers import (
    finite_or_zero,
    qparams_affine,
    qparams_symmetric,
    qparams_symmetric_per_channel,
)
from qat_vit_tpu_torch.quant.qconfig import QConfig


def convert_weight(
    w: torch.Tensor, min_val, max_val, qcfg: QConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight → (int8 values, scale) with observer symmetric qparams."""
    scale, zp = qparams_symmetric(min_val, max_val, qcfg.weight.quant_min, qcfg.weight.quant_max)
    scale, zp = scale.to(w.device), zp.to(w.device)
    w_q = quantize_to_int(w, scale, zp, qcfg.weight.quant_min, qcfg.weight.quant_max)
    return w_q, scale


def act_qparams(min_val, max_val, qcfg: QConfig) -> Dict[str, torch.Tensor]:
    """Activation observer state → {scale, zero_point, quant_max} (0-d f32)."""
    scale, zp = qparams_affine(
        min_val, max_val, qcfg.activation.quant_min, qcfg.activation.quant_max
    )
    return {
        "scale": scale,
        "zero_point": zp,
        "quant_max": torch.tensor(float(qcfg.activation.quant_max)),
    }


# XLA's f32 erf (its ErfImpl32): x clamped to +-erfinv(1 - 2^-23), then
# x * P(x^2) / Q(x^2), each polynomial by Horner steps that the CPU backend
# fuses into FMAs
_ERF_CLAMP = np.float32(3.7439211627767994)
_ERF_P = np.array([2.2905065861350646e-4, 3.4082910107109506e-3, 5.0955695062380861e-2,
                   1.8520832239976145e-1, 1.128379143519084], dtype=np.float32)
_ERF_Q = np.array([-1.1791602954361697e-7, 2.3547966471313185e-5, 1.0179625278914885e-3,
                   1.4070470171167667e-2, 1.1098505178285362e-1, 4.9746925110067538e-1, 1.0],
                  dtype=np.float32)
# sqrt(2) as the f32 divisor: the JAX package's convert runs eagerly, one
# XLA computation per operation, so v / sqrt(2) stays a division there (a
# jitted trace would rewrite it as v * f32(1/sqrt(2)))
_SQRT2 = np.float32(np.sqrt(2.0))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a·b + c`` rounded once, as a fused multiply-add: the product of
    two f32 values is exact in f64."""
    b = b.to(torch.float64) if isinstance(b, torch.Tensor) else float(b)
    c = c.to(torch.float64) if isinstance(c, torch.Tensor) else float(c)
    return (a.to(torch.float64) * b + c).to(torch.float32)


def _horner_fma(x: torch.Tensor, coeffs: np.ndarray) -> torch.Tensor:
    """Horner's rule in f32 with each step one fused multiply-add."""
    r = torch.full_like(x, float(coeffs[0]), dtype=torch.float32)
    for c in coeffs[1:]:
        r = _fma(r, x, c)
    return r


def xla_erf_f32(x: torch.Tensor) -> torch.Tensor:
    """erf of an f32 tensor with XLA's arithmetic (``jax.scipy.special.erf``
    on the CPU), bit for bit: torch.erf differs from it in the last bits of
    about half of all f32 inputs."""
    x = torch.clamp(x.to(torch.float32), torch.tensor(-_ERF_CLAMP), torch.tensor(_ERF_CLAMP))
    x2 = x * x
    return (x * _horner_fma(x2, _ERF_P)) / _horner_fma(x2, _ERF_Q)


# XLA's f32 exp on the CPU (Cephes' expf): m = min(floor(x log2e + 1/2),
# 127), r = x - m ln2 in two FMA steps (ln2 = C1 + C2), a degree-5
# polynomial by FMA Horner steps, exp(r) = 1 + r + r^2 P(r), times 2^m;
# results below the smallest normal f32 flush to 0. The clamp only keeps
# the arithmetic finite: below -104 the result is 0 and above 89 inf either
# way.
_EXP_CLAMP = (np.float32(-104.0), np.float32(89.0))
_EXP_LOG2E = np.float32(1.44269504088896341)
_EXP_C1, _EXP_C2 = np.float32(0.693359375), np.float32(-2.12194440e-4)
_EXP_P = np.array([1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
                   1.6666665459e-1, 5.0000001201e-1], dtype=np.float32)


def xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of an f32 tensor with XLA's arithmetic (``jax.numpy.exp`` on the
    CPU), bit for bit: torch.exp differs from it in the last bit of ~4% of
    f32 inputs."""
    x = torch.clamp(x.to(torch.float32), *(torch.tensor(c) for c in _EXP_CLAMP))
    m = torch.clamp(torch.floor(_fma(x, _EXP_LOG2E, 0.5)), max=127.0)
    r = _fma(-m, _EXP_C1, x)
    r = _fma(-m, _EXP_C2, r)
    y = 1.0 + _fma(_horner_fma(r, _EXP_P), r * r, r)
    return _flush_subnormal(y.to(torch.float64) * torch.exp2(m.to(torch.float64)))


def _flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32 with values below the smallest normal f32 set to 0, as
    XLA's CPU code flushes them."""
    return torch.where(x.abs() < float(np.finfo(np.float32).tiny), 0.0, x).to(torch.float32)


def xla_logistic_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` of an f32 tensor on the CPU, bit for bit: XLA
    computes it as ``1 / (1 + exp(-x))`` with its own f32 exp, the quotient
    flushed below the smallest normal f32."""
    return _flush_subnormal(1.0 / (1.0 + xla_exp_f32(-x)))


def _gelu_erf(v: torch.Tensor) -> torch.Tensor:
    """``v * 0.5 * (1 + erf(v / sqrt(2)))`` in f32 as the JAX package's
    eager convert computes it."""
    return v * 0.5 * (1.0 + xla_erf_f32(v / torch.tensor(_SQRT2)))


def gelu_transform_qparams(min_val, max_val, qcfg: QConfig) -> Dict[str, torch.Tensor]:
    """Static qparams for a GELU output given its input observer range
    ``[a, b]``: ``[min(gelu(a), gelu(b), gmin if a < -0.7518), max(gelu(b), 0)]``
    with GELU's global minimum gmin ≈ -0.17, erf-GELU in f32."""
    a, b = finite_or_zero(min_val).cpu(), finite_or_zero(max_val).cpu()
    gmin = torch.tensor(-0.17000000, dtype=torch.float32)
    ga, gb = _gelu_erf(a), _gelu_erf(b)
    lo = torch.minimum(torch.minimum(ga, gb), torch.where(a < -0.7518, gmin, ga))
    hi = torch.clamp(gb, min=0.0)
    return act_qparams(lo, hi, qcfg)


def act_output_qparams(min_val, max_val, qcfg: QConfig, act: str = "gelu") -> Dict[str, torch.Tensor]:
    """Static qparams for an activation's output given its input range:
    exact for GELU, a 1025-point scan of the interval for quick-GELU.

    GELU's erf and quick-GELU's logistic are XLA's, emulated bit for bit
    (:func:`xla_erf_f32`, :func:`xla_logistic_f32`), so both activations'
    ``gelu_q`` qparams equal the JAX package's (tested)."""
    if act == "gelu":
        return gelu_transform_qparams(min_val, max_val, qcfg)
    if act != "quick_gelu":
        raise ValueError(f"unknown activation {act!r} for int8 conversion")
    a, b = finite_or_zero(min_val).cpu(), finite_or_zero(max_val).cpu()
    ts = torch.linspace(0.0, 1.0, 1025, dtype=torch.float32)
    v = a + (b - a) * ts
    ys = v * xla_logistic_f32(1.702 * v)
    lo = torch.clamp(ys.min(), max=0.0)
    hi = torch.clamp(ys.max(), min=0.0)
    return act_qparams(lo, hi, qcfg)


def dense_int8(
    kernel: torch.Tensor,  # [K, N] float
    bias: Optional[torch.Tensor],
    stats: Dict[str, Any],  # {"weight_fq": {min_val, max_val}, "act_fq": {...}?}
    qcfg: QConfig,
    per_channel: bool = False,
) -> Dict[str, Any]:
    """One QuantDense → int8 bundle: values, weight scale, bias, column sums
    (for the zero-point correction in the int8 GEMM) and its output qparams."""
    w = kernel.to(torch.float32)
    if per_channel:
        w_scale, _ = qparams_symmetric_per_channel(
            w, axis=1, quant_min=qcfg.weight.quant_min, quant_max=qcfg.weight.quant_max
        )
        w_q = quantize_to_int(
            w, w_scale[None, :], 0.0, qcfg.weight.quant_min, qcfg.weight.quant_max
        )
    else:
        w_q, w_scale = convert_weight(
            w, stats["weight_fq"]["min_val"], stats["weight_fq"]["max_val"], qcfg
        )
    out: Dict[str, Any] = {
        "w_int8": w_q.contiguous(),
        "w_scale": w_scale,
        "w_colsum": w_q.to(torch.int32).sum(dim=0, dtype=torch.int32),
        "bias": bias.to(torch.float32) if bias is not None else None,
    }
    if "act_fq" in stats:
        out["out_q"] = act_qparams(stats["act_fq"]["min_val"], stats["act_fq"]["max_val"], qcfg)
    return out


def ln_params(weight: torch.Tensor, bias: torch.Tensor, stats: Dict[str, Any], qcfg: QConfig) -> Dict[str, Any]:
    """QuantLayerNorm → float LN params + its output qparams."""
    return {
        "scale": weight.to(torch.float32),
        "bias": bias.to(torch.float32),
        "out_q": act_qparams(stats["act_fq"]["min_val"], stats["act_fq"]["max_val"], qcfg),
    }
