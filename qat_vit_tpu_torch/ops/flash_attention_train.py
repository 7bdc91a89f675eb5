"""Training attention: the fused forward and its backward as one
``torch.autograd.Function`` each (port of
``qat_vit_tpu/ops/flash_attention_train.py``).

- :func:`attention_train`: MHA over the packed qkv ``[B, N, 3·H·hd]`` →
  ``[B, N, H·hd]``, differentiable. Forward: kernel A
  (``ops/flash_attention.attention_fwd``); backward: kernel B
  (:func:`attention_bwd`, ``csrc/attention_bwd.cu``). Only the raw ``qkv``
  is saved; the ``[B, H, N, N]`` probabilities never exist in memory in
  either direction.
- :func:`attention_train_fq`: the same over the RAW qkv GEMM output with the
  qkv activation fake-quant inside both kernels (``qs = [scale, zp]``, an f32
  device tensor from the already-updated observer). The backward recomputes
  the fake-quant and applies the straight-through estimator's mask to dqkv;
  ``qs`` gets a zero gradient.

On the CPU the kernels' plain versions run (that is how the CPU tests reach
this branch); on CUDA the kernels launch or the wrappers raise. Under
``_cuda.reference_impl()`` the two Functions call the plain versions on any
device: the card's reference run for the kernels, never the main path.
"""

from __future__ import annotations

import torch

from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops._cuda import (
    SMEM_LIMIT,
    bwd_scale_f32,
    ptr,
    reference_on,
    require,
    stream_of,
    use_plain,
)
from qat_vit_tpu_torch.ops.flash_attention import (
    _check_attention,
    attention_fwd,
    attention_fwd_plain,
    attention_shapes_ok,
    check_qs,
    ordered_dot,
    ordered_matmul,
    softmax_pinned,
    split_heads,
)
from qat_vit_tpu_torch.quant.fake_quant import ste_mask

_BWD_WARPS = 8  # WARPS in csrc/attention_bwd.cu


def attention_bwd_smem_bytes(n: int, head_dim: int) -> int:
    """Shared memory kernel B asks for: q, k, v and do of one head (bf16
    rows padded by one word), f64 softmax sums and f32 max / rowsum per row,
    two f32 rows of N and two of hd per warp."""
    return (16 * n * (head_dim // 2 + 1) + 16 * n
            + 8 * (_BWD_WARPS * n + _BWD_WARPS * head_dim))


def attention_train_available(num_heads: int, head_dim: int, seq_len: int = None,
                              dtype: torch.dtype = torch.bfloat16) -> bool:
    """The Hopper kernels' gate: bf16, hd a multiple of 8 and <= 128, and N
    within both kernels' shared-memory budgets (N <= 375 at hd 64: ViT-S and
    ViT-B at 197 tokens pass). True on the CPU as well, where the plain
    versions run, so both devices take the same branch of the model."""
    if dtype != torch.bfloat16 or num_heads < 1:
        return False
    if seq_len is None:
        return attention_shapes_ok(1, head_dim)
    return (attention_shapes_ok(seq_len, head_dim)
            and attention_bwd_smem_bytes(seq_len, head_dim) <= SMEM_LIMIT)


def attention_bwd_plain(qkv: torch.Tensor, do: torch.Tensor, num_heads: int, head_dim: int, *,
                        qs=None, in_fq=None, n_valid: int = None) -> torch.Tensor:
    """Kernel B's arithmetic, rounding for rounding → dqkv in the qkv dtype.

    Scores ``(q·kᵀ)·scale`` and ``dp = do·vᵀ`` accumulate in f32 in index
    order, the softmax is :func:`softmax_pinned`, ``rowsum(dp·p)`` sums f32
    products in f64; ``ds = p·(dp − rowsum)`` and ``p`` are rounded to the qkv
    dtype; dq, dk, dv accumulate in f32 in index order. With ``in_fq`` the
    STE mask from the raw qkv zeroes the gradient where the grid value
    clips."""
    b, n, _ = qkv.shape
    d = num_heads * head_dim
    n_valid = n if n_valid is None else n_valid
    dt = qkv.dtype
    q, k, v = split_heads(qkv, num_heads, head_dim, qs, in_fq)
    g = do.to(dt).reshape(b, n, num_heads, head_dim).transpose(1, 2)
    scale = bwd_scale_f32(head_dim, qkv.device)
    s = (ordered_dot(q, k) * scale).masked_fill(torch.arange(n, device=qkv.device) >= n_valid,
                                                -1e30)
    p = softmax_pinned(s)
    dp = ordered_dot(g, v)
    rowsum = (dp * p).to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)
    ds = (p * (dp - rowsum)).to(dt)
    dq = ordered_matmul(ds, k) * scale
    dk = ordered_matmul(ds.transpose(-1, -2), q) * scale
    dv = ordered_matmul(p.to(dt).transpose(-1, -2), g)
    dqkv = torch.cat([t.transpose(1, 2).reshape(b, n, d) for t in (dq, dk, dv)], dim=-1)
    if in_fq is not None:
        keep = ste_mask(qkv, qs[0], qs[1], in_fq[0], in_fq[1])
        dqkv = torch.where(keep, dqkv, torch.zeros_like(dqkv))
    return dqkv.to(dt)


def attention_bwd(qkv: torch.Tensor, do: torch.Tensor, num_heads: int, head_dim: int, *,
                  qs=None, in_fq=None, n_valid: int = None) -> torch.Tensor:
    """dqkv ``[B, N, 3·H·hd]`` of :func:`attention_fwd` for the output
    gradient ``do`` (kernel B on CUDA, its plain version on the CPU)."""
    if use_plain(qkv):
        return attention_bwd_plain(qkv, do, num_heads, head_dim, qs=qs, in_fq=in_fq,
                                   n_valid=n_valid)
    n_valid = _check_attention(qkv, num_heads, head_dim, n_valid, "attention_bwd")
    b, n, three_d = qkv.shape
    if attention_bwd_smem_bytes(n, head_dim) > SMEM_LIMIT:
        raise ValueError(f"attention_bwd: unsupported n={n}, head_dim={head_dim}")
    require(do, "do", torch.bfloat16, qkv.device, (b, n, num_heads * head_dim))
    if in_fq is not None:
        check_qs(qs, qkv.device)
    dqkv = torch.empty((b, n, three_d), dtype=torch.bfloat16, device=qkv.device)
    if b:
        lo, hi = in_fq if in_fq is not None else (0, 0)
        _build.load().call(
            "qvt_attention_bwd", ptr(qkv), ptr(do), ptr(qs) if in_fq is not None else None,
            ptr(dqkv), b, n, num_heads, head_dim, n_valid,
            float(bwd_scale_f32(head_dim, "cpu")), int(in_fq is not None), float(lo), float(hi),
            stream_of(qkv.device),
        )
        attention_bwd.launches += 1
    return dqkv


attention_bwd.launches = 0


def _impls():
    if reference_on():
        return attention_fwd_plain, attention_bwd_plain
    return attention_fwd, attention_bwd


class _AttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, qs, num_heads, head_dim, in_fq):
        fwd, ctx.bwd = _impls()
        ctx.save_for_backward(qkv, qs)
        ctx.geom = (num_heads, head_dim, in_fq)
        return fwd(qkv, num_heads, head_dim, qs=qs, in_fq=in_fq)

    @staticmethod
    def backward(ctx, do):
        qkv, qs = ctx.saved_tensors
        num_heads, head_dim, in_fq = ctx.geom
        dqkv = ctx.bwd(qkv, do.to(qkv.dtype).contiguous(), num_heads, head_dim, qs=qs,
                       in_fq=in_fq)
        return dqkv, None if qs is None else torch.zeros_like(qs), None, None, None


def attention_train(qkv: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """Fused MHA over the packed qkv ``[B, N, 3·H·hd]`` → ``[B, N, H·hd]``,
    differentiable (kernel A forward, kernel B backward)."""
    return _AttentionTrain.apply(qkv, None, num_heads, head_dim, None)


def attention_train_fq(qkv: torch.Tensor, qs: torch.Tensor, num_heads: int, head_dim: int,
                       quant_min: int, quant_max: int) -> torch.Tensor:
    """Fused (activation fake-quant + MHA) over the RAW packed qkv,
    differentiable; ``qs`` is this step's ``[scale, zero_point]`` (f32,
    device) and gets a zero gradient."""
    return _AttentionTrain.apply(qkv, qs, num_heads, head_dim, (quant_min, quant_max))
