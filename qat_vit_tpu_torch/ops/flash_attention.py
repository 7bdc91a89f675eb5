"""Attention over the packed qkv (port of ``qat_vit_tpu/ops/flash_attention.py``).

- :func:`fused_attention_qkv` with ``out_q``: MHA over ``[B, N, 3·H·hd]``
  with the output quantized to shifted int8 ``[B, N, H·hd]`` (the proj
  GEMM's input). On CUDA it launches the ``attention_q`` kernel
  (``csrc/attention_q.cu``, the port of K3); on the CPU it runs
  :func:`fused_attention_qkv_plain`. Launches are counted in
  ``fused_attention_qkv.launches``.
- :func:`attention_fwd` (and :func:`fused_attention_qkv` without ``out_q``):
  the float-output form, ``[B, N, H·hd]`` in the qkv dtype, optionally with
  the qkv activation fake-quant applied inside (``in_fq=(qmin, qmax)``,
  scale and zero point in the device tensor ``qs = [scale, zp]``). On CUDA
  it launches ``attention_fwd`` (``csrc/attention_q.cu``, kernel A, K1's
  forward); on the CPU it runs :func:`attention_fwd_plain`. Launches are
  counted in ``attention_fwd.launches``.
- :func:`xla_attention_qkv`: the exact path's plain attention.

Numerics of the kernels and their plain versions: with ``in_fq`` q, k, v are
first fake-quantized (f32, half to even, clip, back to the qkv dtype); q
scaled by ``hd**-0.5`` in the qkv dtype (bf16), f32 scores, keys
``>= n_valid`` at -1e30, f32 softmax, probabilities cast to the qkv dtype,
f32 output accumulation, as the TPU kernel; the plain versions pin every
rounding to the kernels'.
"""

from __future__ import annotations

import torch

from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops._cuda import SMEM_LIMIT, ptr, require, stream_of, use_plain
from qat_vit_tpu_torch.ops.fused_serve import inv_scale, quantize_mul
from qat_vit_tpu_torch.ops.quantized_matmul import f32
from qat_vit_tpu_torch.quant.fake_quant import fake_quantize_values

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


def split_heads(qkv: torch.Tensor, num_heads: int, head_dim: int, qs=None, in_fq=None):
    """q, k, v of the packed ``[B, N, 3·H·hd]`` as ``[B, H, N, hd]`` tensors
    in the qkv dtype, fake-quantized first when ``in_fq=(qmin, qmax)``."""
    b, n, _ = qkv.shape
    if in_fq is not None:
        qkv = fake_quantize_values(qkv, qs[0], qs[1], in_fq[0], in_fq[1])
    return tuple(t.reshape(b, n, num_heads, head_dim).transpose(1, 2)
                 for t in qkv.split(num_heads * head_dim, dim=-1))


def ordered_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b^T`` over the last dim, accumulated in f32 one index at a time
    (the kernels' FMA order; for bf16 operands every product is exact)."""
    s = torch.zeros(a.shape[:-1] + b.shape[-2:-1], dtype=torch.float32, device=a.device)
    a, b = a.to(torch.float32), b.to(torch.float32)
    for i in range(a.shape[-1]):
        s = s + a[..., i : i + 1] * b[..., i].unsqueeze(-2)
    return s


def ordered_matmul(p: torch.Tensor, v: torch.Tensor, acc: torch.Tensor = None) -> torch.Tensor:
    """``p @ v`` (``acc + p @ v`` with an f32 ``acc``), accumulated in f32
    one row of ``v`` at a time."""
    if acc is None:
        acc = torch.zeros(p.shape[:-1] + v.shape[-1:], dtype=torch.float32, device=p.device)
    p, v = p.to(torch.float32), v.to(torch.float32)
    for j in range(v.shape[-2]):
        acc = acc + p[..., j : j + 1] * v[..., j : j + 1, :]
    return acc


def softmax_pinned(s: torch.Tensor) -> torch.Tensor:
    """The kernels' f32 softmax: exp of the f32 difference to the row max in
    f64, rounded to f32; the sum in f64; p rounded to f32 once."""
    e = torch.exp((s - s.amax(dim=-1, keepdim=True)).to(torch.float64))
    e = e.to(torch.float32).to(torch.float64)
    return (e / e.sum(dim=-1, keepdim=True)).to(torch.float32)


def _attention_plain(qkv, num_heads, head_dim, n_valid, qs=None, in_fq=None) -> torch.Tensor:
    """The kernels' attention, rounding for rounding → f32 ``[B, N, H·hd]``."""
    b, n, _ = qkv.shape
    n_valid = n if n_valid is None else n_valid
    q, k, v = split_heads(qkv, num_heads, head_dim, qs, in_fq)
    s = ordered_dot(q * _q_scale(head_dim, qkv.dtype).to(qkv.device), k)
    s = s.masked_fill(torch.arange(n, device=qkv.device) >= n_valid, -1e30)
    p = softmax_pinned(s).to(qkv.dtype)
    return ordered_matmul(p, v).transpose(1, 2).reshape(b, n, num_heads * head_dim)


def fused_attention_qkv_plain(qkv: torch.Tensor, num_heads: int, head_dim: int, *,
                              out_q: dict, quant_max=255.0, n_valid: int = None) -> torch.Tensor:
    """``attention_q``'s arithmetic, rounding for rounding: both dots
    accumulate in f32 in index order (d for the scores, then keys for p @ v;
    the bf16 products are exact in f32, so the kernel's FMA rounds as this
    multiply then add does), exp and the softmax sum run in f64 and are
    rounded to f32 once."""
    o = _attention_plain(qkv, num_heads, head_dim, n_valid)
    return quantize_mul(o, inv_scale(out_q["scale"]), f32(out_q["zero_point"]), f32(quant_max))


def attention_fwd_plain(qkv: torch.Tensor, num_heads: int, head_dim: int, *, qs=None,
                        in_fq=None, n_valid: int = None) -> torch.Tensor:
    """``attention_fwd``'s arithmetic, rounding for rounding (as
    :func:`fused_attention_qkv_plain`, with the fake-quant prologue and the
    output rounded to the qkv dtype). Any float dtype."""
    return _attention_plain(qkv, num_heads, head_dim, n_valid, qs, in_fq).to(qkv.dtype)


def _check_attention(qkv, num_heads, head_dim, n_valid, name):
    b, n, three_d = qkv.shape
    if three_d != 3 * num_heads * head_dim:
        raise ValueError(f"qkv last dim {three_d} != 3 * {num_heads} * {head_dim}")
    if not attention_shapes_ok(n, head_dim):
        raise ValueError(f"{name}: unsupported n={n}, head_dim={head_dim}")
    n_valid = n if n_valid is None else n_valid
    if not 0 < n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside (0, {n}]")
    require(qkv, "qkv", torch.bfloat16, qkv.device, (b, n, three_d))
    return n_valid


def check_qs(qs: torch.Tensor, device: torch.device) -> None:
    """``qs``: the f32 ``[scale, zero_point]`` pair, on the kernel's device."""
    require(qs, "qs", torch.float32, device, (2,))


def attention_fwd(qkv: torch.Tensor, num_heads: int, head_dim: int, *, qs=None, in_fq=None,
                  n_valid: int = None) -> torch.Tensor:
    """MHA over the packed qkv → ``[B, N, H·hd]`` in the qkv dtype; with
    ``in_fq=(qmin, qmax)`` q, k, v are fake-quantized with ``qs`` first."""
    if use_plain(qkv):
        return attention_fwd_plain(qkv, num_heads, head_dim, qs=qs, in_fq=in_fq, n_valid=n_valid)
    n_valid = _check_attention(qkv, num_heads, head_dim, n_valid, "attention_fwd")
    if in_fq is not None:
        check_qs(qs, qkv.device)
    b, n, _ = qkv.shape
    out = torch.empty((b, n, num_heads * head_dim), dtype=torch.bfloat16, device=qkv.device)
    if b:
        lo, hi = in_fq if in_fq is not None else (0, 0)
        _build.load().call(
            "qvt_attention_fwd", ptr(qkv), ptr(qs) if in_fq is not None else None, ptr(out),
            b, n, num_heads, head_dim, n_valid, float(_q_scale(head_dim, torch.bfloat16)),
            int(in_fq is not None), float(lo), float(hi), stream_of(qkv.device),
        )
        attention_fwd.launches += 1
    return out


attention_fwd.launches = 0


def fused_attention_qkv(qkv: torch.Tensor, num_heads: int, head_dim: int, *,
                        out_q: dict = None, quant_max=255.0,
                        n_valid: int = None) -> torch.Tensor:
    """MHA over the packed qkv → shifted int8 ``[B, N, H·hd]`` with
    ``out_q``, else ``[B, N, H·hd]`` in the qkv dtype (:func:`attention_fwd`)."""
    if out_q is None:
        return attention_fwd(qkv, num_heads, head_dim, n_valid=n_valid)
    if use_plain(qkv):
        return fused_attention_qkv_plain(qkv, num_heads, head_dim, out_q=out_q,
                                         quant_max=quant_max, n_valid=n_valid)
    n_valid = _check_attention(qkv, num_heads, head_dim, n_valid, "attention_q")
    b, n, _ = qkv.shape
    out = torch.empty((b, n, num_heads * head_dim), dtype=torch.int8, device=qkv.device)
    if b:
        _build.load().call(
            "qvt_attention_q", ptr(qkv), ptr(out), b, n, num_heads, head_dim, n_valid,
            float(_q_scale(head_dim, torch.bfloat16)), inv_scale(out_q["scale"]),
            f32(out_q["zero_point"]), f32(quant_max), stream_of(qkv.device),
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
