"""Fused quantize → int8 GEMM → dequantize (port of ``qat_vit_tpu/ops/pallas_gemm.py``, K7).

:func:`fused_quantize_matmul` takes a float activation ``x [..., K]`` (f32
or bf16), quantizes it on the uint8 grid stored shifted to int8,
``clamp(round(x · (1/s_x) + zp), 0, qmax) − 128`` with ``1/s_x`` computed
in f32 (K7 MULTIPLIES by the reciprocal; the exact path's
``quantize_act_shifted`` divides, so the two may differ by one grid step),
runs the int8 product with ``w_q [K, N]`` and dequantizes,
``(acc − z_s·colsum)·(s_x·w_scale[n]) + bias`` in f32 (``s_x·w_scale[n]``
first, per column; per-tensor or per-channel ``w_scale``), cast once to
``out_dtype``.

On CUDA it launches ``qvt_quantize_gemm`` (``csrc/int8_gemm_wgmma.cu``:
each block quantizes a 64-row strip of x into shared memory once and runs
``wgmma`` on it against the weight streamed by TMA, the PLAIN epilogue
after); launches are counted in ``fused_quantize_matmul.launches``. The
kernel reads the weight packed k-contiguous, ``[N, K]``: the export's
``layer["w_int8_t"]`` passed as ``w_t`` (``quantized_dense`` does), which
must be ``fused_serve.pack_k_major(w_q)`` (checked on the device the first
time a ``w_t`` comes with a given ``w_q`` tensor: a stale or foreign packed
weight raises), else packed here from ``w_q`` on every call. On
the CPU, and inside ``_cuda.reference_impl()``, it runs
:func:`fused_quantize_matmul_plain`. The kernel zero-fills the 16-element
chunks past K in x's strip and TMA the weight's, so it takes any K a
multiple of 16 (every K JAX's gate admits); another K raises (never a
quiet fallback).

:func:`fused_quantize_matmul_available` keeps the JAX gate's SHAPE
conditions (``K % 32``, ``N % 128``, ``K·N`` ≤ 6 MiB) and drops its
backend test, so the port takes K7 for the same layers on every device.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

import torch

from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops._cuda import ptr, reference_on, require, stream_of, use_plain
from qat_vit_tpu_torch.ops.fused_serve import (
    GEMM_K_MULTIPLE,
    inv_scale,
    pack_k_major,
    quantize_mul,
)
from qat_vit_tpu_torch.ops.quantized_matmul import f32, int8_matmul, is_per_channel

# the JAX gate's shape rules (TPU lane 128, int8 sublane 32, panel budget)
_LANE = 128
_INT8_SUBLANE = 32
_MAX_PANEL_BYTES = 6 * 1024 * 1024


def fused_quantize_matmul_available(x_shape: Tuple[int, ...], w_shape: Tuple[int, int]) -> bool:
    """JAX's shape gate for K7 (``pallas_gemm.py:37-48``) without its
    backend test: the layers the JAX package runs through K7 on the TPU."""
    k, n = w_shape
    return (x_shape[-1] == k and k % _INT8_SUBLANE == 0 and n % _LANE == 0
            and k * n <= _MAX_PANEL_BYTES)


def fused_quantize_matmul_plain(x, w_q, *, x_scale, x_zero_point, w_scale, w_colsum,
                                bias=None, x_quant_max=255.0, out_dtype=torch.float32):
    """K7's arithmetic in plain PyTorch (``int8_matmul`` after the
    multiply-quantize)."""
    x_q = quantize_mul(x.to(torch.float32), inv_scale(x_scale), f32(x_zero_point),
                       f32(x_quant_max))
    return int8_matmul(x_q, w_q, x_scale=x_scale, x_zero_point=x_zero_point, w_scale=w_scale,
                       w_colsum=w_colsum, bias=bias, out_dtype=torch.float32).to(out_dtype)


def fused_quantize_matmul(
    x: torch.Tensor,  # [..., K] f32 or bf16
    w_q: torch.Tensor,  # [K, N] int8
    *,
    x_scale,
    x_zero_point,
    w_scale,
    w_colsum: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    x_quant_max=255.0,
    out_dtype=torch.float32,
    w_t: Optional[torch.Tensor] = None,  # [N, K] int8: w_q packed k-contiguous
) -> torch.Tensor:
    """quantize(x) @ w_q, dequantized, in one kernel → ``[..., N]`` ``out_dtype``;
    ``w_t``, where given, is ``pack_k_major(w_q)``."""
    if use_plain(x) or reference_on():
        return fused_quantize_matmul_plain(
            x, w_q, x_scale=x_scale, x_zero_point=x_zero_point, w_scale=w_scale,
            w_colsum=w_colsum, bias=bias, x_quant_max=x_quant_max, out_dtype=out_dtype)
    dev = x.device
    if w_q.ndim != 2:
        raise ValueError(f"w_q: expected [K, N], got {tuple(w_q.shape)}")
    k, n = w_q.shape
    if k % GEMM_K_MULTIPLE:
        raise ValueError(f"fused_quantize_matmul: unsupported K={k} (a multiple of "
                         f"{GEMM_K_MULTIPLE}: the kernel reads x in 16-element chunks)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_quantize_matmul: x must be f32 or bf16, not {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_quantize_matmul writes f32 or bf16, not {out_dtype}")
    lead = tuple(x.shape[:-1])
    require(x, "x", x.dtype, dev, lead + (k,), align=16)
    require(w_q, "w_q", torch.int8, dev, (k, n))
    if w_t is None:
        w_t = pack_k_major(w_q)
    else:
        require(w_t, "w_t", torch.int8, dev, (n, k), align=16)
        _check_packed(w_q, w_t)
    require(w_colsum, "w_colsum", torch.int32, dev, (n,))
    if bias is not None:
        require(bias, "bias", torch.float32, dev, (n,))
    if is_per_channel(w_scale):
        require(w_scale, "w_scale", torch.float32, dev, (n,))
        ws_ptr, ws0, per_channel = w_scale.data_ptr(), 0.0, 1
    else:
        ws_ptr, ws0, per_channel = None, f32(w_scale), 0
    m = x.numel() // k
    y = torch.empty(lead + (n,), dtype=out_dtype, device=dev)
    if m:
        s_x, zp = f32(x_scale), f32(x_zero_point)
        _build.load().call(
            "qvt_quantize_gemm", ptr(x), ptr(w_t), ptr(w_colsum), ptr(bias), ws_ptr, ptr(y),
            m, n, k, int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            per_channel, ws0, s_x, int(zp) - 128, inv_scale(s_x), zp,
            f32(x_quant_max), stream_of(dev),
        )
        fused_quantize_matmul.launches += 1
    return y


fused_quantize_matmul.launches = 0


def _check_packed(w_q: torch.Tensor, w_t: torch.Tensor) -> None:
    """Raise unless ``w_t`` is ``pack_k_major(w_q)``: compared on the device
    the first time ``w_t`` comes with this ``w_q`` tensor, then remembered on
    ``w_t`` (a weak reference to ``w_q``), so a served model pays it once per
    layer."""
    seen = getattr(w_t, "_qvt_packed_of", None)
    if seen is not None and seen() is w_q:
        return
    if not torch.equal(w_t, w_q.t()):
        raise ValueError("w_t is not pack_k_major(w_q): a stale or foreign packed weight")
    w_t._qvt_packed_of = weakref.ref(w_q)
