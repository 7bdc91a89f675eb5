"""Attention over the packed qkv (port of ``qat_vit_tpu/ops/flash_attention.py``).

- :func:`fused_attention_qkv` with ``out_q``: MHA over ``[B, N, 3·H·hd]``
  with the output quantized to shifted int8 ``[B, N, H·hd]`` (the proj
  GEMM's input). On CUDA it launches the ``attention_q`` kernel
  (``csrc/attention_q.cu``, the port of K3); on the CPU it runs
  :func:`fused_attention_qkv_plain`. Launches are counted in
  ``fused_attention_qkv.launches``.
- :func:`xla_attention_qkv`: the exact path's plain attention.

Numerics of the kernel and its plain version: q scaled by ``hd**-0.5`` in
the qkv dtype (bf16), f32 scores, keys ``>= n_valid`` at -1e30, f32
softmax, probabilities cast to the qkv dtype, f32 output accumulation, as
the TPU kernel; the plain version pins every rounding to the kernel's.
"""

from __future__ import annotations

import torch

from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops._cuda import SMEM_LIMIT, ptr, require, stream_of, use_plain
from qat_vit_tpu_torch.ops.fused_serve import inv_scale, quantize_mul
from qat_vit_tpu_torch.ops.quantized_matmul import f32

_WARPS = 8  # WARPS in csrc/attention_q.cu


def attention_smem_bytes(n: int, head_dim: int) -> int:
    """Shared memory the kernel asks for: K (rows padded by one word) and V
    of one head, one f32 score row and one q row per warp."""
    return 4 * (n * (head_dim // 2 + 1) + n * (head_dim // 2) + _WARPS * n + _WARPS * head_dim)


def attention_shapes_ok(n: int, head_dim: int) -> bool:
    """The kernel's gate: hd a multiple of 8 and <= 128, n within the
    shared-memory budget (n <= 789 at hd 64)."""
    return (head_dim % 8 == 0 and 0 < head_dim <= 128
            and attention_smem_bytes(n, head_dim) <= SMEM_LIMIT)


def _q_scale(head_dim: int, dtype: torch.dtype) -> torch.Tensor:
    # the TPU kernels multiply by hd**-0.5 cast to the input dtype
    return torch.tensor(head_dim ** -0.5, dtype=dtype)


def fused_attention_qkv_plain(qkv: torch.Tensor, num_heads: int, head_dim: int, *,
                              out_q: dict, quant_max=255.0, n_valid: int = None) -> torch.Tensor:
    """The kernel's arithmetic, rounding for rounding: both dots accumulate in
    f32 in index order (d for the scores, then keys for p @ v; the bf16
    products are exact in f32, so the kernel's FMA rounds as this multiply
    then add does), exp and the softmax sum run in f64 and are rounded to
    f32 once."""
    b, n, _ = qkv.shape
    d = num_heads * head_dim
    n_valid = n if n_valid is None else n_valid
    q, k, v = (t.reshape(b, n, num_heads, head_dim).transpose(1, 2)  # [b, h, n, hd]
               for t in qkv.split(d, dim=-1))
    q = (q * _q_scale(head_dim, qkv.dtype).to(qkv.device)).to(torch.float32)
    k, v = k.to(torch.float32), v.to(torch.float32)
    s = torch.zeros((b, num_heads, n, n), dtype=torch.float32, device=qkv.device)
    for i in range(head_dim):
        s = s + q[..., i : i + 1] * k[..., i].unsqueeze(-2)
    s = s.masked_fill(torch.arange(n, device=qkv.device) >= n_valid, -1e30)
    e = torch.exp((s - s.amax(dim=-1, keepdim=True)).to(torch.float64)).to(torch.float32)
    e64 = e.to(torch.float64)
    p = (e64 / e64.sum(dim=-1, keepdim=True)).to(torch.float32).to(qkv.dtype).to(torch.float32)
    o = torch.zeros((b, num_heads, n, head_dim), dtype=torch.float32, device=qkv.device)
    for j in range(n):
        o = o + p[..., j : j + 1] * v[:, :, j : j + 1, :]
    o = o.transpose(1, 2).reshape(b, n, d)
    return quantize_mul(o, inv_scale(out_q["scale"]), f32(out_q["zero_point"]), f32(quant_max))


def fused_attention_qkv(qkv: torch.Tensor, num_heads: int, head_dim: int, *,
                        out_q: dict = None, quant_max=255.0,
                        n_valid: int = None) -> torch.Tensor:
    """Quantizing MHA over the packed qkv → shifted int8 ``[B, N, H·hd]``."""
    if out_q is None:
        raise NotImplementedError(
            "fused_attention_qkv without out_q (the float-output form, K3/K8) is "
            "not ported yet: ROADMAP.md Queue 2"
        )
    if use_plain(qkv):
        return fused_attention_qkv_plain(qkv, num_heads, head_dim, out_q=out_q,
                                         quant_max=quant_max, n_valid=n_valid)
    dev = qkv.device
    b, n, three_d = qkv.shape
    d = num_heads * head_dim
    if three_d != 3 * d:
        raise ValueError(f"qkv last dim {three_d} != 3 * {num_heads} * {head_dim}")
    if not attention_shapes_ok(n, head_dim):
        raise ValueError(f"attention_q: unsupported n={n}, head_dim={head_dim}")
    n_valid = n if n_valid is None else n_valid
    if not 0 < n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside (0, {n}]")
    require(qkv, "qkv", torch.bfloat16, dev, (b, n, three_d))
    out = torch.empty((b, n, d), dtype=torch.int8, device=dev)
    if b:
        _build.load().call(
            "qvt_attention_q", ptr(qkv), ptr(out), b, n, num_heads, head_dim, n_valid,
            float(_q_scale(head_dim, torch.bfloat16)), inv_scale(out_q["scale"]),
            f32(out_q["zero_point"]), f32(quant_max), stream_of(dev),
        )
        fused_attention_qkv.launches += 1
    return out


fused_attention_qkv.launches = 0


def xla_attention_qkv(qkv: torch.Tensor, num_heads: int, head_dim: int,
                      softmax_dtype=torch.float32) -> torch.Tensor:
    """Plain attention of the exact path: scores in ``softmax_dtype``,
    probabilities cast back to the qkv dtype."""
    b, n, _ = qkv.shape
    d = num_heads * head_dim
    q, k, v = (t.reshape(b, n, num_heads, head_dim) for t in qkv.split(d, dim=-1))
    scores = torch.einsum("bqhd,bkhd->bhqk", (q * head_dim ** -0.5).to(softmax_dtype),
                          k.to(softmax_dtype))
    p = torch.softmax(scores, dim=-1).to(qkv.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, n, d)
