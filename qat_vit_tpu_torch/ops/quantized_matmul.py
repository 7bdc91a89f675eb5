"""Int8 GEMM algebra, plain PyTorch (port of ``qat_vit_tpu/ops/quantized_matmul.py``).

Activations are uint8 affine (scale ``s_x``, zero-point ``z``) stored
shifted by -128 as int8; weights are int8 symmetric (scale ``s_w``). With
``z_s = z - 128``::

    y = (x_s · W_q - z_s · colsum(W_q)) · s_x·s_w + b

:func:`int8_matmul` is the plain version of the ``int8_gemm`` kernel's PLAIN
epilogue (``ops/fused_serve.int8_dense``): the integer product runs in
float64, which is exact (``|acc| <= K·128·127 < 2**53``) on every device —
``torch.matmul`` has no int32 GEMM on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def f32(v) -> float:
    """A 0-d tensor / numpy / Python scalar as the Python float of its f32 value."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().item()
    return float(np.float32(v))


def quantize_act_shifted(x: torch.Tensor, scale, zero_point, quant_max=255.0) -> torch.Tensor:
    """f32 → shifted int8 (uint8 grid − 128): ``clamp(round(x / s + zp), 0, qmax) − 128``."""
    q = torch.round(x.to(torch.float32) / f32(scale) + f32(zero_point))
    q = torch.clamp(q, 0.0, f32(quant_max)) - 128.0
    return q.to(torch.int8)


def is_per_channel(w_scale) -> bool:
    return isinstance(w_scale, torch.Tensor) and w_scale.ndim > 0


def int8_matmul(
    x_q: torch.Tensor,  # [..., M, K] shifted int8
    w_q: torch.Tensor,  # [K, N] int8
    *,
    x_scale,
    x_zero_point,  # the uint8 zero-point (unshifted)
    w_scale,
    w_colsum: torch.Tensor,  # [N] int32
    bias: Optional[torch.Tensor] = None,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Dequantized int8 GEMM, plain PyTorch: ``(acc − z_s·colsum)`` in int32
    → f32 → ``· (s_x·s_w)`` (that product first, in f32) ``+ b``."""
    acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64)).to(torch.int32)
    z_s = int(f32(x_zero_point)) - 128
    a = acc - z_s * w_colsum.to(device=acc.device, dtype=torch.int32)
    if is_per_channel(w_scale):
        sw = w_scale.to(device=acc.device, dtype=torch.float32) * f32(x_scale)
    else:
        sw = float(np.float32(f32(x_scale)) * np.float32(f32(w_scale)))
    y = a.to(torch.float32) * sw
    if bias is not None:
        y = y + bias.to(device=acc.device, dtype=torch.float32)
    return y.to(out_dtype)


def quantized_dense(x: torch.Tensor, layer: dict, in_q: dict, *,
                    use_pallas: Optional[bool] = None,
                    out_dtype=torch.float32) -> torch.Tensor:
    """quantize(x) → int8 GEMM → dequant(+bias): one layer of the exact path.

    ``use_pallas`` follows the JAX rule: ``None`` is ``False``; ``True``
    takes the fused kernel K7 (``ops/pallas_gemm.fused_quantize_matmul``:
    multiply-quantize) where ``fused_quantize_matmul_available`` admits the
    shape and this division path otherwise. The gate has no backend test
    here, so the CPU runs K7's plain version where the JAX package on a CPU
    would divide: the port mirrors the TPU's behaviour."""
    if use_pallas:
        from qat_vit_tpu_torch.ops import pallas_gemm

        if pallas_gemm.fused_quantize_matmul_available(x.shape, layer["w_int8"].shape):
            return pallas_gemm.fused_quantize_matmul(
                x, layer["w_int8"], x_scale=in_q["scale"], x_zero_point=in_q["zero_point"],
                x_quant_max=in_q.get("quant_max", 255.0), w_scale=layer["w_scale"],
                w_colsum=layer["w_colsum"], bias=layer.get("bias"), out_dtype=out_dtype,
                w_t=layer.get("w_int8_t"),
            )
    x_q = quantize_act_shifted(x, in_q["scale"], in_q["zero_point"], in_q.get("quant_max", 255.0))
    return int8_matmul(
        x_q, layer["w_int8"], x_scale=in_q["scale"], x_zero_point=in_q["zero_point"],
        w_scale=layer["w_scale"], w_colsum=layer["w_colsum"], bias=layer.get("bias"),
        out_dtype=out_dtype,
    )
