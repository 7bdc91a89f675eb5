"""Long-sequence attention over the packed qkv (port of
``qat_vit_tpu/ops/long_attention.py``, K5's forward, and of the attention
stage of ``qat_vit_tpu/ops/long_block_kernel.py``, K6).

- :func:`long_attention_qkv`: MHA over ``[B, N, 3·H·hd]`` → ``[B, N, H·hd]``
  in the qkv dtype (K5a). On CUDA it launches ``qvt_attention_long``
  (``csrc/attention_long.cu``); launches are counted in
  ``long_attention_qkv.launches``. With ``out_q`` it is
  :func:`long_attention_q`.
- :func:`long_attention_q`: the same attention with the output quantized to
  shifted int8 on the ``out_q`` grid (K6's attention stage, the proj GEMM's
  input; the ``out_q`` / ``quant_max`` contract of
  ``flash_attention.fused_attention_qkv``). On CUDA it launches
  ``qvt_attention_long_q``; launches in ``long_attention_q.launches``.

On the CPU both run :func:`long_attention_qkv_plain`: the arithmetic of
``flash_attention._attention_plain`` (q scaled by ``hd**-0.5`` in the qkv
dtype, index-ordered f32 dots, f64 exp and softmax sum rounded to f32 once,
p rounded to the qkv dtype, keys ``>= n_valid`` at -1e30), one image and one
stripe of query rows at a time: a batch-8 f64 score tensor at 2,305 tokens
would hold ~3 GB.

The kernel keeps score rows, not K and V, in shared memory (one head's K
and V at 2,305 × 64 bf16 are 295 KB each, over the 227 KB a block may use),
so the gate is on that plan: hd a multiple of 8 and at most 128, and
:func:`long_attention_smem_bytes` within the limit (N <= 6,048 at hd 64).
The TPU's lane and VMEM rules do not apply.

Training (K5 with its backward, K5b):

- :func:`long_attention_bwd`: dqkv ``[B, N, 3·H·hd]`` for the output
  gradient ``do``; on CUDA it calls ``qvt_attention_long_bwd``
  (``csrc/attention_long_bwd.cu``), which launches two kernels, the
  deterministic rows and keys passes: ``long_attention_bwd.launches`` counts
  both, 2 per call; on the CPU
  :func:`long_attention_bwd_plain`, the TPU backward's numerics (q scaled in
  bf16 before the score dot; dq and dk scaled in f32 after their dots, dk
  with the unscaled q; ds rounded to bf16 from the f32 p, p rounded only for
  dv; dk and dv summed in f32 over every query and rounded once), one image
  and one query stripe at a time.
- :func:`long_attention_train`: the differentiable pair, a
  ``torch.autograd.Function`` that saves only ``qkv``; forward
  :func:`long_attention_qkv`, backward :func:`long_attention_bwd`; through
  the plain versions under ``_cuda.reference_impl()``.
- :func:`long_attention_train_available`: both kernels' gates and the JAX
  package's cap on the pair (N rounded up to 256 at most 4,096), so that
  both packages take the long-sequence branch at the same N.
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
    _q_scale,
    ordered_dot,
    ordered_matmul,
    softmax_pinned,
    split_heads,
)
from qat_vit_tpu_torch.ops.fused_serve import inv_scale, quantize_mul
from qat_vit_tpu_torch.ops.quantized_matmul import f32

# the layout of csrc/attention_long.cu: query rows per block, keys per tile
Q_TILE, KEY_TILE = 8, 128
# query rows per block of pass 1 of csrc/attention_long_bwd.cu
BWD_ROWS = 4
# query rows per step of the plain versions
PLAIN_Q_STRIPE = 1024
# the JAX package's cap on the training pair (qat_vit_tpu/ops/long_attention.py:
# _MAX_N_PAD at its q_tile 256)
TRAIN_MAX_N_PAD, TRAIN_Q_TILE = 4096, 256


def long_attention_smem_bytes(n: int, head_dim: int) -> int:
    """Shared memory the kernel asks for: the block's f32 score rows (row
    stride rounded up to 4), its scaled q rows (f32), and two key tiles of
    16-byte chunks (rows padded by one chunk)."""
    n4 = -(-n // 4) * 4
    return 4 * (Q_TILE * n4 + Q_TILE * head_dim) + 16 * 2 * KEY_TILE * (head_dim // 8 + 1)


def long_attention_shapes_ok(n: int, head_dim: int) -> bool:
    """The kernel's gate: hd a multiple of 8 and <= 128, n within the
    shared-memory plan."""
    return (head_dim % 8 == 0 and 0 < head_dim <= 128 and n > 0
            and long_attention_smem_bytes(n, head_dim) <= SMEM_LIMIT)


def long_attention_bwd_smem_bytes(n: int, head_dim: int) -> int:
    """Shared memory pass 1 of the backward asks for: the block's f32 score
    and dp rows (row stride rounded up to 4), its scaled q and do rows
    (f32), and two key tiles of 16-byte chunks (rows padded by one chunk).
    Pass 2 needs at most ~93 KB at any N."""
    n4 = -(-n // 4) * 4
    return (4 * (2 * BWD_ROWS * n4 + 2 * BWD_ROWS * head_dim)
            + 16 * 2 * KEY_TILE * (head_dim // 8 + 1))


def long_attention_bwd_shapes_ok(n: int, head_dim: int) -> bool:
    """The backward kernel's gate: hd a multiple of 8 and <= 128, n within
    pass 1's shared-memory plan (N <= 6,048 at hd 64, 4,960 at hd 128)."""
    return (head_dim % 8 == 0 and 0 < head_dim <= 128 and n > 0
            and long_attention_bwd_smem_bytes(n, head_dim) <= SMEM_LIMIT)


def long_attention_train_available(num_heads: int, head_dim: int, seq_len: int,
                                   dtype: torch.dtype = torch.bfloat16) -> bool:
    """The training pair's gate: bf16, both kernels' shapes, and the JAX
    package's cap (N rounded up to 256 at most 4,096), so that both packages
    take the long-sequence branch at the same N. True on the CPU as well,
    where the plain versions run."""
    if dtype != torch.bfloat16 or num_heads < 1:
        return False
    if -(-seq_len // TRAIN_Q_TILE) * TRAIN_Q_TILE > TRAIN_MAX_N_PAD:
        return False
    return (long_attention_shapes_ok(seq_len, head_dim)
            and long_attention_bwd_shapes_ok(seq_len, head_dim))


def _long_attention_f32(qkv, num_heads, head_dim, n_valid) -> torch.Tensor:
    """The kernel's attention, rounding for rounding → f32 ``[B, N, H·hd]``."""
    b, n, _ = qkv.shape
    n_valid = n if n_valid is None else n_valid
    out = torch.empty((b, n, num_heads * head_dim), dtype=torch.float32, device=qkv.device)
    masked = torch.arange(n, device=qkv.device) >= n_valid
    scale = _q_scale(head_dim, qkv.dtype).to(qkv.device)
    for i in range(b):
        q, k, v = split_heads(qkv[i : i + 1], num_heads, head_dim)  # [1, H, N, hd]
        q = q * scale
        for r0 in range(0, n, PLAIN_Q_STRIPE):
            s = ordered_dot(q[:, :, r0 : r0 + PLAIN_Q_STRIPE], k).masked_fill(masked, -1e30)
            o = ordered_matmul(softmax_pinned(s).to(qkv.dtype), v)  # [1, H, rows, hd]
            out[i, r0 : r0 + o.shape[2]] = o[0].transpose(0, 1).reshape(o.shape[2], -1)
    return out


def long_attention_qkv_plain(qkv: torch.Tensor, num_heads: int, head_dim: int, *,
                             out_q: dict = None, quant_max=255.0,
                             n_valid: int = None) -> torch.Tensor:
    """The kernels' arithmetic: ``[B, N, H·hd]`` in the qkv dtype, or with
    ``out_q`` quantized (multiply by ``1/scale``) to shifted int8."""
    o = _long_attention_f32(qkv, num_heads, head_dim, n_valid)
    if out_q is None:
        return o.to(qkv.dtype)
    return quantize_mul(o, inv_scale(out_q["scale"]), f32(out_q["zero_point"]), f32(quant_max))


def _check(qkv, num_heads, head_dim, n_valid, name) -> int:
    b, n, three_d = qkv.shape
    if three_d != 3 * num_heads * head_dim:
        raise ValueError(f"qkv last dim {three_d} != 3 * {num_heads} * {head_dim}")
    if not long_attention_shapes_ok(n, head_dim):
        raise ValueError(f"{name}: unsupported n={n}, head_dim={head_dim} (needs hd % 8 == 0, "
                         f"hd <= 128 and {long_attention_smem_bytes(n, head_dim)} bytes of "
                         f"shared memory <= {SMEM_LIMIT})")
    n_valid = n if n_valid is None else n_valid
    if not 0 < n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside (0, {n}]")
    require(qkv, "qkv", torch.bfloat16, qkv.device, (b, n, three_d), align=16)
    return n_valid


def long_attention_qkv(qkv: torch.Tensor, num_heads: int, head_dim: int, *,
                       out_q: dict = None, quant_max=255.0,
                       n_valid: int = None) -> torch.Tensor:
    """Long-sequence MHA over the packed qkv → ``[B, N, H·hd]`` in the qkv
    dtype; with ``out_q``, shifted int8 (:func:`long_attention_q`)."""
    if out_q is not None:
        return long_attention_q(qkv, num_heads, head_dim, out_q=out_q, quant_max=quant_max,
                                n_valid=n_valid)
    if use_plain(qkv):
        return long_attention_qkv_plain(qkv, num_heads, head_dim, n_valid=n_valid)
    n_valid = _check(qkv, num_heads, head_dim, n_valid, "attention_long")
    b, n, _ = qkv.shape
    out = torch.empty((b, n, num_heads * head_dim), dtype=torch.bfloat16, device=qkv.device)
    if b:
        _build.load().call(
            "qvt_attention_long", ptr(qkv), ptr(out), b, n, num_heads, head_dim, n_valid,
            float(_q_scale(head_dim, torch.bfloat16)), stream_of(qkv.device),
        )
        long_attention_qkv.launches += 1
    return out


def long_attention_q(qkv: torch.Tensor, num_heads: int, head_dim: int, *, out_q: dict,
                     quant_max=255.0, n_valid: int = None) -> torch.Tensor:
    """Long-sequence MHA over the packed qkv → shifted int8 ``[B, N, H·hd]``
    on the ``out_q`` grid."""
    if use_plain(qkv):
        return long_attention_qkv_plain(qkv, num_heads, head_dim, out_q=out_q,
                                        quant_max=quant_max, n_valid=n_valid)
    n_valid = _check(qkv, num_heads, head_dim, n_valid, "attention_long_q")
    b, n, _ = qkv.shape
    out = torch.empty((b, n, num_heads * head_dim), dtype=torch.int8, device=qkv.device)
    if b:
        _build.load().call(
            "qvt_attention_long_q", ptr(qkv), ptr(out), b, n, num_heads, head_dim, n_valid,
            float(_q_scale(head_dim, torch.bfloat16)), inv_scale(out_q["scale"]),
            f32(out_q["zero_point"]), f32(quant_max), stream_of(qkv.device),
        )
        long_attention_q.launches += 1
    return out


long_attention_qkv.launches = 0
long_attention_q.launches = 0


def long_attention_bwd_plain(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                             head_dim: int, *, n_valid: int = None) -> torch.Tensor:
    """The backward kernel's arithmetic, rounding for rounding → dqkv in the
    qkv dtype: scores of the bf16-scaled q and ``dp = do·vᵀ`` in f32 in index
    order, :func:`softmax_pinned`, ``rowsum(dp·p)`` of f32 products in f64;
    ``ds = p·(dp − rowsum)`` rounded to the qkv dtype; ``dq = (ds·k)·scale``
    per row, ``dk = (dsᵀ·q)·scale`` with the unscaled q and ``dv = pᵀ·do``
    (p rounded) summed in f32 over every query in index order, rounded once.
    Query rows ``>= n_valid`` are padding: their ``do`` is taken as zero."""
    b, n, _ = qkv.shape
    d = num_heads * head_dim
    n_valid = n if n_valid is None else n_valid
    dt, dev = qkv.dtype, qkv.device
    padded = torch.arange(n, device=dev) >= n_valid
    qscale = _q_scale(head_dim, dt).to(dev)
    scale = bwd_scale_f32(head_dim, dev)
    dqkv = torch.empty((b, n, 3 * d), dtype=dt, device=dev)

    def packed(t):  # [1, H, rows, hd] -> [rows, H·hd]
        return t[0].transpose(0, 1).reshape(t.shape[2], d).to(dt)

    for i in range(b):
        q, k, v = split_heads(qkv[i : i + 1], num_heads, head_dim)  # [1, H, N, hd]
        g = do[i : i + 1].to(dt).reshape(1, n, num_heads, head_dim).transpose(1, 2)
        g = g.masked_fill(padded[:, None], 0)
        qs = q * qscale
        dk = torch.zeros((1, num_heads, n, head_dim), dtype=torch.float32, device=dev)
        dv = torch.zeros_like(dk)
        for r0 in range(0, n, PLAIN_Q_STRIPE):
            r1 = min(r0 + PLAIN_Q_STRIPE, n)
            p = softmax_pinned(ordered_dot(qs[:, :, r0:r1], k).masked_fill(padded, -1e30))
            dp = ordered_dot(g[:, :, r0:r1], v)
            rowsum = (dp * p).to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)
            ds = (p * (dp - rowsum)).to(dt)
            dqkv[i, r0:r1, :d] = packed(ordered_matmul(ds, k) * scale)
            dk = ordered_matmul(ds.transpose(-1, -2), q[:, :, r0:r1], dk)
            dv = ordered_matmul(p.to(dt).transpose(-1, -2), g[:, :, r0:r1], dv)
        dqkv[i, :, d : 2 * d] = packed(dk * scale)
        dqkv[i, :, 2 * d :] = packed(dv)
    return dqkv


def long_attention_bwd(qkv: torch.Tensor, do: torch.Tensor, num_heads: int, head_dim: int, *,
                       n_valid: int = None) -> torch.Tensor:
    """dqkv ``[B, N, 3·H·hd]`` of :func:`long_attention_qkv` for the output
    gradient ``do`` (K5b on CUDA, its plain version on the CPU)."""
    if use_plain(qkv):
        return long_attention_bwd_plain(qkv, do, num_heads, head_dim, n_valid=n_valid)
    n_valid = _check(qkv, num_heads, head_dim, n_valid, "attention_long_bwd")
    b, n, three_d = qkv.shape
    if not long_attention_bwd_shapes_ok(n, head_dim):
        raise ValueError(f"attention_long_bwd: unsupported n={n}, head_dim={head_dim} "
                         f"({long_attention_bwd_smem_bytes(n, head_dim)} bytes of shared memory "
                         f"> {SMEM_LIMIT})")
    require(do, "do", torch.bfloat16, qkv.device, (b, n, num_heads * head_dim), align=16)
    dqkv = torch.empty((b, n, three_d), dtype=torch.bfloat16, device=qkv.device)
    if b:
        # pass 1 -> pass 2: each row's max, f64 softmax sum and rowsum
        stats = torch.empty((b, num_heads, n, 4), dtype=torch.float64, device=qkv.device)
        _build.load().call(
            "qvt_attention_long_bwd", ptr(qkv), ptr(do), ptr(dqkv), ptr(stats), b, n, num_heads,
            head_dim, n_valid, float(_q_scale(head_dim, torch.bfloat16)),
            float(bwd_scale_f32(head_dim, "cpu")), stream_of(qkv.device),
        )
        long_attention_bwd.launches += 2  # the rows pass and the keys pass
    return dqkv


long_attention_bwd.launches = 0


class _LongAttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, head_dim):
        plain = reference_on()
        ctx.bwd = long_attention_bwd_plain if plain else long_attention_bwd
        ctx.save_for_backward(qkv)
        ctx.geom = (num_heads, head_dim)
        fwd = long_attention_qkv_plain if plain else long_attention_qkv
        return fwd(qkv, num_heads, head_dim)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        return ctx.bwd(qkv, do.to(qkv.dtype).contiguous(), *ctx.geom), None, None


def long_attention_train(qkv: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """Long-sequence MHA over the packed qkv ``[B, N, 3·H·hd]`` → ``[B, N,
    H·hd]``, differentiable (K5a forward, K5b backward); only ``qkv`` is
    saved, so the ``[B, H, N, N]`` probabilities never exist in memory."""
    return _LongAttentionTrain.apply(qkv, num_heads, head_dim)
