"""Attention over the packed qkv (port of ``qat_vit_tpu/ops/flash_attention.py``).

- :func:`fused_attention_qkv` with ``out_q``: MHA over ``[B, N, 3·H·hd]``
  with the output quantized to shifted int8 ``[B, N, H·hd]`` (the proj
  GEMM's input). On CUDA it launches ``qvt_attention_q_mma``
  (``csrc/attention_q_mma.cu``, the port of K3, on the tensor cores); on
  the CPU it runs :func:`fused_attention_qkv_plain`. Launches are counted in
  ``fused_attention_qkv.launches``.
- :func:`attention_fwd` (and :func:`fused_attention_qkv` without ``out_q``):
  the float-output form, ``[B, N, H·hd]`` in the qkv dtype (bf16 or f32),
  optionally with the qkv activation fake-quant applied inside
  (``in_fq=(qmin, qmax)``, scale and zero point in the device tensor
  ``qs = [scale, zp]``). On CUDA it launches kernel A, K1's forward: for
  bf16 ``qvt_attention_fwd_mma`` (``csrc/attention_q_mma.cu``, tensor
  cores), for f32 ``qvt_attention_fwd`` (``csrc/attention_f32.cu``,
  register tiles on the CUDA cores, :func:`attention_f32_rows` queries per
  block); on the CPU it runs :func:`attention_fwd_plain`. It takes every N
  that JAX's K1 gate admits (:func:`attention_fwd_shapes_ok`).
  Launches are counted in ``attention_fwd.launches``.
- :func:`flash_attention_qkv` (K8, ``attn_impl="pallas"``): the float
  attention of ``flash_attention.py::_attention_kernel``, f32 or bf16 in
  and out, with the f32 SCORE scaled by ``hd**-0.5`` after the dot (the
  kernels above scale q in the qkv dtype before it). On CUDA it launches
  kernel A's kernels in their scale-after form: for bf16
  ``qvt_flash_attention_mma`` (``csrc/attention_q_mma.cu``, tensor cores),
  for f32 ``qvt_flash_attention_f32`` (``csrc/attention_f32.cu``); on the
  CPU, and inside ``_cuda.reference_impl()``,
  :func:`flash_attention_qkv_plain`. Launches in
  ``flash_attention_qkv.launches``. It takes every N that kernel A takes
  (:func:`flash_attention_shapes_ok`). The TPU wrapper pads N to 128 with
  masked keys; padded keys get exactly zero probability, so the port runs
  the unpadded N.
- :func:`xla_attention_qkv`: the exact path's plain attention.

Numerics of the kernels and their plain versions: with ``in_fq`` q, k, v are
first fake-quantized (f32, half to even, clip, back to the qkv dtype); q
scaled by ``hd**-0.5`` in the qkv dtype, f32 scores, keys
``>= n_valid`` at -1e30, f32 softmax, probabilities cast to the qkv dtype,
f32 output accumulation, as the TPU kernel. The plain versions sum in index
order with the softmax in f64. The f32 kernels (kernel A, K8) pin every
rounding to them; the tensor-core K3, bf16 kernel A and bf16 K8 sum in
the tensor cores' order with a two-pass softmax (the normalised p rounded
to bf16), so on the card K3 is held to one int8 step and >= 99.9%
identical, the bf16 kernel A and K8 to 2^-7 (1 + |plain|) and to twice
the plain version's distance from the f64 math.
"""

from __future__ import annotations

import torch

from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops._cuda import (
    SMEM_LIMIT,
    ptr,
    reference_on,
    require,
    stream_of,
    use_plain,
)
from qat_vit_tpu_torch.ops.fused_serve import inv_scale, quantize_mul
from qat_vit_tpu_torch.ops.quantized_matmul import f32
from qat_vit_tpu_torch.quant.fake_quant import fake_quantize_values

_F32_KT = 64  # KT in csrc/attention_f32.cu: keys per G1 tile
# the qkv dtypes of the training attentions' kernels (K1, K5a/K5b)
TRAIN_DTYPES = (torch.bfloat16, torch.float32)


def _f32_strip_words(n: int) -> int:
    """Words per row of a score strip in ``csrc/attention_f32.cu``: ``n``
    rounded up to 4, then to 8 mod 32."""
    n4 = -(-n // 4) * 4
    return n4 + (8 - n4) % 32


def attention_f32_smem_bytes(n: int, head_dim: int, rows: int, backward: bool = False) -> int:
    """Shared memory of a block of ``rows`` queries of the f32 kernel A
    (``backward``: of kernel B's rows pass) in ``csrc/attention_f32.cu``:
    the block's q rows (and do rows), at least 16 of each, a 128-key K / V
    tile, all f32 rows padded to hd + 4 words, and the score strip (and the
    dp strip) of ``rows`` x ``n``."""
    ld = head_dim + 4
    strips = (2 if backward else 1) * rows * _f32_strip_words(n)
    return 4 * ((2 if backward else 1) * max(rows, 16) * ld + 2 * _F32_KT * ld + strips)


def attention_f32_rows(n: int, head_dim: int, backward: bool = False) -> int:
    """Queries per block of the f32 kernel A (``backward``: kernel B's rows
    pass), as the kernel picks them: the most of 32, 16, .., 1 whose plan
    fits in the shared memory; 0 where none does."""
    for rows in (32, 16, 8, 4, 2, 1):
        if attention_f32_smem_bytes(n, head_dim, rows, backward) <= SMEM_LIMIT:
            return rows
    return 0


def attention_fwd_shapes_ok(n: int, head_dim: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """The gate of kernel A and of K3 (bf16 only): hd a multiple of 8 and <=
    128; in bf16 any n (the tensor-core kernels stream K and V past 227 KB),
    in f32 every n with a plan (:func:`attention_f32_rows`: n <= ~39,000 at
    hd 128, past any N that JAX's K1 gate admits)."""
    if head_dim % 8 or not 0 < head_dim <= 128 or n < 1:
        return False
    return dtype != torch.float32 or attention_f32_rows(n, head_dim) > 0


def flash_attention_shapes_ok(n: int, head_dim: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """K8's gate. K8 runs kernel A's kernels with the score scaled after the
    dot, so it takes what they take (:func:`attention_fwd_shapes_ok`): in
    bf16 any n >= 1, in f32 every n with a plan, at hd a multiple of 8 up
    to 128. JAX's ``flash_attention_qkv`` has no gate at all; the head dims
    it takes and the port does not (hd % 8 != 0 or hd > 128) are a named
    residue (ROADMAP Queue 3)."""
    return attention_fwd_shapes_ok(n, head_dim, dtype)


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


def _check_attention(qkv, num_heads, head_dim, n_valid, name, dtypes=(torch.bfloat16,),
                     shapes_ok=attention_fwd_shapes_ok):
    b, n, three_d = qkv.shape
    if three_d != 3 * num_heads * head_dim:
        raise ValueError(f"qkv last dim {three_d} != 3 * {num_heads} * {head_dim}")
    if qkv.dtype not in dtypes:
        raise ValueError(f"{name}: qkv dtype {qkv.dtype}, expected one of {dtypes}")
    if not shapes_ok(n, head_dim, qkv.dtype):
        raise ValueError(f"{name}: unsupported n={n}, head_dim={head_dim} in {qkv.dtype}")
    n_valid = n if n_valid is None else n_valid
    if not 0 < n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside (0, {n}]")
    require(qkv, "qkv", qkv.dtype, qkv.device, (b, n, three_d))
    return n_valid


def check_qs(qs: torch.Tensor, device: torch.device) -> None:
    """``qs``: the f32 ``[scale, zero_point]`` pair, on the kernel's device."""
    require(qs, "qs", torch.float32, device, (2,))


def attention_fwd(qkv: torch.Tensor, num_heads: int, head_dim: int, *, qs=None, in_fq=None,
                  n_valid: int = None) -> torch.Tensor:
    """MHA over the packed qkv (bf16 or f32) → ``[B, N, H·hd]`` in the qkv
    dtype; with ``in_fq=(qmin, qmax)`` q, k, v are fake-quantized with ``qs``
    first."""
    if use_plain(qkv):
        return attention_fwd_plain(qkv, num_heads, head_dim, qs=qs, in_fq=in_fq, n_valid=n_valid)
    n_valid = _check_attention(qkv, num_heads, head_dim, n_valid, "attention_fwd",
                               TRAIN_DTYPES, attention_fwd_shapes_ok)
    if qkv.dtype == torch.float32:  # the f32 kernel stages 16-byte chunks
        require(qkv, "qkv", qkv.dtype, qkv.device, align=16)
    if in_fq is not None:
        check_qs(qs, qkv.device)
    b, n, _ = qkv.shape
    out = torch.empty((b, n, num_heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    if b:
        lo, hi = in_fq if in_fq is not None else (0, 0)
        _build.load().call(
            "qvt_attention_fwd" if qkv.dtype == torch.float32 else "qvt_attention_fwd_mma",
            ptr(qkv), ptr(qs) if in_fq is not None else None, ptr(out), b, n, num_heads,
            head_dim, n_valid, float(_q_scale(head_dim, qkv.dtype)), int(in_fq is not None),
            float(lo), float(hi), stream_of(qkv.device),
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
            "qvt_attention_q_mma", ptr(qkv), ptr(out), b, n, num_heads, head_dim, n_valid,
            float(_q_scale(head_dim, torch.bfloat16)), inv_scale(out_q["scale"]),
            f32(out_q["zero_point"]), f32(quant_max), stream_of(qkv.device),
        )
        fused_attention_qkv.launches += 1
    return out


fused_attention_qkv.launches = 0


def flash_attention_qkv_plain(qkv: torch.Tensor, num_heads: int, head_dim: int, *,
                              n_valid: int = None) -> torch.Tensor:
    """K8's arithmetic, rounding for rounding: the f32 score dot in index
    order (multiply, then add), THEN × f32 ``hd**-0.5``, keys ``>= n_valid``
    at -1e30, the pinned f32 softmax, p in the qkv dtype, p @ v in f32 in
    key order, the output in the qkv dtype (f32 or bf16)."""
    b, n, _ = qkv.shape
    n_valid = n if n_valid is None else n_valid
    q, k, v = split_heads(qkv, num_heads, head_dim)
    s = ordered_dot(q, k) * torch.tensor(head_dim ** -0.5, dtype=torch.float32, device=qkv.device)
    s = s.masked_fill(torch.arange(n, device=qkv.device) >= n_valid, -1e30)
    p = softmax_pinned(s).to(qkv.dtype)
    o = ordered_matmul(p, v).transpose(1, 2).reshape(b, n, num_heads * head_dim)
    return o.to(qkv.dtype)


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int, head_dim: int, *,
                        n_valid: int = None) -> torch.Tensor:
    """MHA over the packed qkv → ``[B, N, H·hd]`` in the qkv dtype (f32 or
    bf16), the score scaled after its dot (K8, ``attn_impl="pallas"``)."""
    if use_plain(qkv) or reference_on():
        return flash_attention_qkv_plain(qkv, num_heads, head_dim, n_valid=n_valid)
    n_valid = _check_attention(qkv, num_heads, head_dim, n_valid, "flash_attention",
                               TRAIN_DTYPES, flash_attention_shapes_ok)
    if qkv.dtype == torch.float32:  # the f32 kernel stages 16-byte chunks
        require(qkv, "qkv", qkv.dtype, qkv.device, align=16)
    b, n, _ = qkv.shape
    out = torch.empty((b, n, num_heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    if b:
        _build.load().call(
            "qvt_flash_attention_f32" if qkv.dtype == torch.float32 else "qvt_flash_attention_mma",
            ptr(qkv), ptr(out), b, n, num_heads, head_dim, n_valid, head_dim ** -0.5,
            stream_of(qkv.device),
        )
        flash_attention_qkv.launches += 1
    return out


flash_attention_qkv.launches = 0


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
