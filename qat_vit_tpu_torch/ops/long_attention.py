"""Long-sequence attention over the packed qkv (port of
``qat_vit_tpu/ops/long_attention.py``, K5's forward, and of the attention
stage of ``qat_vit_tpu/ops/long_block_kernel.py``, K6).

- :func:`long_attention_qkv`: MHA over ``[B, N, 3·H·hd]`` → ``[B, N, H·hd]``
  in the qkv dtype, bf16 or f32 (K5a). On CUDA a bf16 qkv launches
  ``qvt_attention_long_mma`` (``csrc/attention_long_mma.cu``: a streaming
  online-softmax forward on the tensor cores), an f32 one kernel A's f32
  kernel, ``qvt_attention_fwd`` without ``in_fq`` (``csrc/attention_f32.cu``:
  the plain version below does kernel A's arithmetic, rounding for
  rounding); launches are counted in ``long_attention_qkv.launches``. With
  ``out_q`` it is :func:`long_attention_q`.
- :func:`long_attention_q`: the same attention with the output quantized to
  shifted int8 on the ``out_q`` grid (K6's attention stage, the proj GEMM's
  input; the ``out_q`` / ``quant_max`` contract of
  ``flash_attention.fused_attention_qkv``). On CUDA it launches
  ``qvt_attention_long_q_mma`` (``csrc/attention_long_q_mma.cu``: a
  streaming two-pass forward on the tensor cores); launches in
  ``long_attention_q.launches``.
- :func:`long_attention_q8`: that stage with int8 score dots (K6's
  ``int8_scores``, the ``i8`` serving flag): q and k as shifted int8 on the
  ``out_q`` grid, their corrected integer dot times ``s_o²·hd^-0.5``; on
  CUDA ``qvt_attention_long_q8_mma`` (the same kernel with the scores on
  int8 ``mma.sync``), launches in ``long_attention_q8.launches``; on the
  CPU :func:`long_attention_q8_plain`.

On the CPU the first two run :func:`long_attention_qkv_plain`: the arithmetic of
``flash_attention._attention_plain`` (q scaled by ``hd**-0.5`` in the qkv
dtype, index-ordered f32 dots, f64 exp and softmax sum rounded to f32 once,
p rounded to the qkv dtype, keys ``>= n_valid`` at -1e30), one image and one
stripe of query rows at a time: a batch-8 f64 score tensor at 2,305 tokens
would hold ~3 GB.

Two kinds of kernel, two kinds of gate. The f32 forms keep score rows, not
K and V, in shared memory (one head's K and V at 2,305 × 64 in f32 are 590
KB each, over the 227 KB a block may use) and replay their plain versions
bit for bit; their gates are their plans at hd a multiple of 8 and at most
128: K5a's kernel A's (:func:`long_attention_shapes_ok`, N to ~39,000 at
hd 128), K5b's kernel B's rows pass (:func:`long_attention_bwd_shapes_ok`,
N to ~18,000 at hd 128). The bf16 pair K5a /
K5b and K6's two int8-output forms stream K and V through tiles on the
tensor cores, keep only tiles in shared memory and so take any N at such an
hd (:func:`long_attention_stream_ok`, JAX's ``long_attention_shapes_ok``);
they sum in the tensor cores' order and use the card's ``ex2``, so they
are held to a tolerance against their index-order plain versions, not to
identity: the bf16 pair by :func:`tc_errors`, K6's int8 outputs to at most
one grid step off and >= 99.9% identical. A K6 chain is chaotic: any
change of rounding in its attention stage moves a nine-block OWLv2 chain's
outputs by ~3e-2 (rel L2; ``port_scripts/k6_chain_check.py``), so the chain
is held to the exact f32 path's bounds. The TPU's lane and VMEM rules do not
apply.

Training (K5 with its backward, K5b):

- :func:`long_attention_bwd`: dqkv ``[B, N, 3·H·hd]`` for the output
  gradient ``do``; on CUDA a bf16 qkv calls ``qvt_attention_long_bwd_mma``
  (``csrc/attention_long_bwd_mma.cu``, from the forward's output and
  log-sum-exp, which it computes first unless ``out`` and ``lse`` are
  given), an f32 one kernel B's f32 passes with K5b's arithmetic,
  ``qvt_attention_long_bwd_rows`` then ``qvt_attention_long_bwd_keys``
  (``csrc/attention_f32.cu``: q scaled before the score dot, dk from the
  unscaled q, the rows of ``do`` past ``n_valid`` taken as zero; the
  statistics in a ``[3, B, H, N]`` f64 scratch; bit-identical to the plain
  version); either launches two kernels, the deterministic rows and keys passes, and
  ``long_attention_bwd.launches`` counts both, 2 per call; on the CPU
  :func:`long_attention_bwd_plain`, the TPU backward's numerics (q scaled in
  the qkv dtype before the score dot; dq and dk scaled in f32 after their
  dots, dk with the unscaled q; ds rounded to the qkv dtype from the f32 p,
  p rounded only for dv; dk and dv summed in f32 over every query and
  rounded once), one image and one query stripe at a time.
- :func:`long_attention_train`: the differentiable pair, a
  ``torch.autograd.Function``: forward :func:`long_attention_qkv`, backward
  :func:`long_attention_bwd`; in bf16 on CUDA it saves ``qkv``, the output
  and the f32 log-sum-exp (``[B, H, N]``), else only ``qkv``; through the
  plain versions under ``_cuda.reference_impl()``.
- :func:`long_attention_train_available`: both kernels' gates and the JAX
  package's cap on the pair (N rounded up to 256 at most 4,096), so that
  both packages take the long-sequence branch at the same N.
"""

from __future__ import annotations

import numpy as np
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
    TRAIN_DTYPES,
    _q_scale,
    attention_f32_rows,
    attention_fwd_shapes_ok,
    ordered_dot,
    ordered_matmul,
    softmax_pinned,
    split_heads,
)
from qat_vit_tpu_torch.ops.fused_serve import inv_scale, quantize_mul
from qat_vit_tpu_torch.ops.quantized_matmul import f32
from qat_vit_tpu_torch.quant.fake_quant import fake_quantize_values, ste_mask

# query rows per step of the plain versions
PLAIN_Q_STRIPE = 1024
# the JAX package's cap on the training pair (qat_vit_tpu/ops/long_attention.py:
# _MAX_N_PAD at its q_tile 256)
TRAIN_MAX_N_PAD, TRAIN_Q_TILE = 4096, 256


def long_attention_shapes_ok(n: int, head_dim: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """K5a's gate: in bf16 the streaming gate (:func:`long_attention_stream_ok`,
    any n), in f32 the plan of kernel A's f32 kernel, which it runs
    (``flash_attention.attention_fwd_shapes_ok``: n <= 39,080 at hd 128);
    hd a multiple of 8 and <= 128."""
    return attention_fwd_shapes_ok(n, head_dim, dtype)


def long_attention_bwd_shapes_ok(n: int, head_dim: int,
                                 dtype: torch.dtype = torch.bfloat16) -> bool:
    """K5b's gate: hd a multiple of 8 and <= 128; in bf16 any n (the
    tensor-core pair streams, :func:`long_attention_stream_ok`), in f32
    every n with a plan of kernel B's rows pass, which it runs
    (``flash_attention.attention_f32_rows(n, hd, backward=True)``: n <=
    18,472 at hd 128)."""
    if not long_attention_stream_ok(n, head_dim):
        return False
    return dtype != torch.float32 or attention_f32_rows(n, head_dim, backward=True) > 0


def long_attention_stream_ok(n: int, head_dim: int) -> bool:
    """The tensor-core kernels' gate (K5a and K5b in bf16, K6's two int8
    forms): any n >= 1 at hd a multiple of 8 and <= 128, JAX's
    ``long_attention_shapes_ok``; only tiles of 64 rows live in shared
    memory."""
    return head_dim % 8 == 0 and 0 < head_dim <= 128 and n > 0


def _stream_gate(n: int, head_dim: int, dtype: torch.dtype) -> bool:
    del dtype
    return long_attention_stream_ok(n, head_dim)


def long_attention_train_available(num_heads: int, head_dim: int, seq_len: int,
                                   dtype: torch.dtype = torch.bfloat16) -> bool:
    """The training pair's gate: bf16 or f32, both kernels' gates for that
    dtype, and the JAX package's cap (N rounded up to 256 at most 4,096), so
    that both packages take the long-sequence branch at the same N (the f32
    plans hold every N to 4,096 at every admitted hd). True on the CPU as
    well, where the plain versions run."""
    if dtype not in TRAIN_DTYPES or num_heads < 1:
        return False
    if -(-seq_len // TRAIN_Q_TILE) * TRAIN_Q_TILE > TRAIN_MAX_N_PAD:
        return False
    return (long_attention_shapes_ok(seq_len, head_dim, dtype)
            and long_attention_bwd_shapes_ok(seq_len, head_dim, dtype))


def _long_attention_f32(qkv, num_heads, head_dim, n_valid, qk8=None,
                        out_q=None) -> torch.Tensor:
    """The kernel's attention, rounding for rounding → f32 ``[B, N, H·hd]``.
    With ``qk8`` (the int8 q and k on the ``out_q`` grid) the scores are the
    int8 form's: the corrected integer dot, exact in f64, times
    ``s_o²·hd^-0.5`` in f32."""
    b, n, _ = qkv.shape
    d = num_heads * head_dim
    n_valid = n if n_valid is None else n_valid
    out = torch.empty((b, n, d), dtype=torch.float32, device=qkv.device)
    masked = torch.arange(n, device=qkv.device) >= n_valid
    scale = _q_scale(head_dim, qkv.dtype).to(qkv.device)
    if qk8 is not None:
        zq8 = int(f32(out_q["zero_point"])) - 128
        sscale = torch.tensor(q8_score_scale(out_q["scale"], head_dim), device=qkv.device)
    for i in range(b):
        q, k, v = split_heads(qkv[i : i + 1], num_heads, head_dim)  # [1, H, N, hd]
        if qk8 is not None:
            q8, k8 = (t.to(torch.float64).reshape(1, n, num_heads, head_dim).transpose(1, 2)
                      for t in qk8[i : i + 1].split(d, dim=-1))
            rk = k8.sum(dim=-1)[:, :, None, :]
        else:
            q = q * scale
        for r0 in range(0, n, PLAIN_Q_STRIPE):
            if qk8 is None:
                s = ordered_dot(q[:, :, r0 : r0 + PLAIN_Q_STRIPE], k)
            else:
                qq = q8[:, :, r0 : r0 + PLAIN_Q_STRIPE]
                corr = (qq @ k8.transpose(-1, -2) - zq8 * (qq.sum(dim=-1, keepdim=True) + rk)
                        + head_dim * zq8 * zq8)
                s = corr.to(torch.float32) * sscale
            o = ordered_matmul(softmax_pinned(s.masked_fill(masked, -1e30)).to(qkv.dtype), v)
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


def q8_score_scale(scale, head_dim: int) -> float:
    """``s_o · s_o · hd^-0.5`` in f32, in that order: the factor of the int8
    form's corrected integer score (JAX ``s_o * s_o * jnp.float32(scale)``)."""
    s = np.float32(f32(scale))
    return float(s * s * np.float32(head_dim ** -0.5))


def long_attention_q8_plain(qk8: torch.Tensor, qkv: torch.Tensor, num_heads: int,
                            head_dim: int, *, out_q: dict, quant_max=255.0,
                            n_valid: int = None) -> torch.Tensor:
    """The int8-score kernel's arithmetic → shifted int8 ``[B, N, H·hd]`` on
    the ``out_q`` grid: scores from the int8 q and k of ``qk8`` (``[B, N,
    2·H·hd]``, shifted int8 on ``out_q``, zero point z' = zp − 128) as
    ``f32(q8·k8 − z'(Σq8 + Σk8) + hd·z'²) · s_o²·hd^-0.5``, the integer part
    exact in f64 (|·| < 2²⁴); then the bf16 form's softmax and ``p·v`` over
    the v of ``qkv``."""
    o = _long_attention_f32(qkv, num_heads, head_dim, n_valid, qk8=qk8, out_q=out_q)
    return quantize_mul(o, inv_scale(out_q["scale"]), f32(out_q["zero_point"]), f32(quant_max))


def _check(qkv, num_heads, head_dim, n_valid, name, dtypes=(torch.bfloat16,),
           gate=long_attention_shapes_ok) -> int:
    """Validate the launch against the kernel's ``gate(n, hd, dtype)``."""
    b, n, three_d = qkv.shape
    if three_d != 3 * num_heads * head_dim:
        raise ValueError(f"qkv last dim {three_d} != 3 * {num_heads} * {head_dim}")
    if qkv.dtype not in dtypes:
        raise ValueError(f"{name}: qkv dtype {qkv.dtype}, expected one of {dtypes}")
    if not gate(n, head_dim, qkv.dtype):
        raise ValueError(f"{name}: unsupported n={n}, head_dim={head_dim} in {qkv.dtype} (needs "
                         f"hd % 8 == 0 and hd <= 128; the f32 forms also N within their "
                         f"shared-memory plans, {SMEM_LIMIT} bytes)")
    n_valid = n if n_valid is None else n_valid
    if not 0 < n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside (0, {n}]")
    require(qkv, "qkv", qkv.dtype, qkv.device, (b, n, three_d), align=16)
    return n_valid


def long_attention_qkv(qkv: torch.Tensor, num_heads: int, head_dim: int, *,
                       out_q: dict = None, quant_max=255.0,
                       n_valid: int = None) -> torch.Tensor:
    """Long-sequence MHA over the packed qkv (bf16 or f32) → ``[B, N, H·hd]``
    in the qkv dtype; with ``out_q``, shifted int8 (:func:`long_attention_q`)."""
    if out_q is not None:
        return long_attention_q(qkv, num_heads, head_dim, out_q=out_q, quant_max=quant_max,
                                n_valid=n_valid)
    if use_plain(qkv):
        return long_attention_qkv_plain(qkv, num_heads, head_dim, n_valid=n_valid)
    return _attention_launch(qkv, num_heads, head_dim, n_valid)[0]


def _attention_launch(qkv, num_heads, head_dim, n_valid, want_lse=False):
    """K5a on CUDA → (out, lse): the f32 ``[B, H, N]`` log-sum-exp of each
    row's scores with ``want_lse`` (bf16 only), else None."""
    n_valid = _check(qkv, num_heads, head_dim, n_valid, "attention_long", TRAIN_DTYPES)
    b, n, _ = qkv.shape
    out = torch.empty((b, n, num_heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
           if want_lse else None)
    if b:
        scale = float(_q_scale(head_dim, qkv.dtype))
        if qkv.dtype == torch.bfloat16:
            _build.load().call("qvt_attention_long_mma", ptr(qkv), ptr(out), ptr(lse), b, n,
                               num_heads, head_dim, n_valid, scale, stream_of(qkv.device))
        else:  # kernel A's f32 kernel, no in_fq
            _build.load().call("qvt_attention_fwd", ptr(qkv), None, ptr(out), b, n, num_heads,
                               head_dim, n_valid, scale, 0, 0.0, 0.0, stream_of(qkv.device))
        long_attention_qkv.launches += 1
    return out, lse


def long_attention_q(qkv: torch.Tensor, num_heads: int, head_dim: int, *, out_q: dict,
                     quant_max=255.0, n_valid: int = None) -> torch.Tensor:
    """Long-sequence MHA over the packed qkv → shifted int8 ``[B, N, H·hd]``
    on the ``out_q`` grid."""
    if use_plain(qkv):
        return long_attention_qkv_plain(qkv, num_heads, head_dim, out_q=out_q,
                                        quant_max=quant_max, n_valid=n_valid)
    n_valid = _check(qkv, num_heads, head_dim, n_valid, "attention_long_q",
                     gate=_stream_gate)
    b, n, _ = qkv.shape
    out = torch.empty((b, n, num_heads * head_dim), dtype=torch.int8, device=qkv.device)
    if b:
        _build.load().call(
            "qvt_attention_long_q_mma", ptr(qkv), ptr(out), b, n, num_heads, head_dim, n_valid,
            float(_q_scale(head_dim, torch.bfloat16)), inv_scale(out_q["scale"]),
            f32(out_q["zero_point"]), f32(quant_max), stream_of(qkv.device),
        )
        long_attention_q.launches += 1
    return out


def long_attention_q8(qk8: torch.Tensor, qkv: torch.Tensor, num_heads: int, head_dim: int, *,
                      out_q: dict, quant_max=255.0, n_valid: int = None) -> torch.Tensor:
    """The int8-score form of :func:`long_attention_q` (K6's
    ``int8_scores``): q and k from ``qk8`` (``[B, N, 2·H·hd]`` shifted int8
    on the ``out_q`` grid, as ``fused_serve.int8_dense_q8`` writes them), v
    from the bf16 ``qkv`` → shifted int8 ``[B, N, H·hd]`` on ``out_q``."""
    if use_plain(qkv):
        return long_attention_q8_plain(qk8, qkv, num_heads, head_dim, out_q=out_q,
                                       quant_max=quant_max, n_valid=n_valid)
    n_valid = _check(qkv, num_heads, head_dim, n_valid, "attention_long_q8",
                     gate=_stream_gate)
    b, n, _ = qkv.shape
    require(qk8, "qk8", torch.int8, qkv.device, (b, n, 2 * num_heads * head_dim))
    out = torch.empty((b, n, num_heads * head_dim), dtype=torch.int8, device=qkv.device)
    if b:
        _build.load().call(
            "qvt_attention_long_q8_mma", ptr(qk8), ptr(qkv), ptr(out), b, n, num_heads, head_dim,
            n_valid, q8_score_scale(out_q["scale"], head_dim),
            int(f32(out_q["zero_point"])) - 128, inv_scale(out_q["scale"]),
            f32(out_q["zero_point"]), f32(quant_max), stream_of(qkv.device),
        )
        long_attention_q8.launches += 1
    return out


long_attention_qkv.launches = 0
long_attention_q.launches = 0
long_attention_q8.launches = 0


def long_attention_bwd_plain(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                             head_dim: int, *, n_valid: int = None, out=None,
                             lse=None) -> torch.Tensor:
    """The backward kernel's arithmetic, rounding for rounding → dqkv in the
    qkv dtype: scores of the q scaled in that dtype and ``dp = do·vᵀ`` in f32 in index
    order, :func:`softmax_pinned`, ``rowsum(dp·p)`` of f32 products in f64;
    ``ds = p·(dp − rowsum)`` rounded to the qkv dtype; ``dq = (ds·k)·scale``
    per row, ``dk = (dsᵀ·q)·scale`` with the unscaled q and ``dv = pᵀ·do``
    (p rounded) summed in f32 over every query in index order, rounded once.
    Query rows ``>= n_valid`` are padding: their ``do`` is taken as zero.
    ``out`` and ``lse`` (the kernel's statistics) are accepted and ignored."""
    del out, lse
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
                       n_valid: int = None, out: torch.Tensor = None,
                       lse: torch.Tensor = None) -> torch.Tensor:
    """dqkv ``[B, N, 3·H·hd]`` of :func:`long_attention_qkv` for the output
    gradient ``do`` (K5b on CUDA, its plain version on the CPU). A bf16 qkv
    on CUDA takes the forward's output ``out`` and f32 log-sum-exp ``lse``
    (``[B, H, N]``), and runs the forward first when either is missing (a
    launch of ``long_attention_qkv``); the plain version and the f32 form
    ignore both."""
    if use_plain(qkv):
        return long_attention_bwd_plain(qkv, do, num_heads, head_dim, n_valid=n_valid)
    n_valid = _check(qkv, num_heads, head_dim, n_valid, "attention_long_bwd", TRAIN_DTYPES,
                     gate=long_attention_bwd_shapes_ok)
    b, n, three_d = qkv.shape
    dev, d = qkv.device, num_heads * head_dim
    require(do, "do", qkv.dtype, dev, (b, n, d), align=16)
    dqkv = torch.empty((b, n, three_d), dtype=qkv.dtype, device=dev)
    if not b:
        return dqkv
    qscale, scale = float(_q_scale(head_dim, qkv.dtype)), float(bwd_scale_f32(head_dim, "cpu"))
    if qkv.dtype == torch.bfloat16:
        if out is None or lse is None:
            out, lse = _attention_launch(qkv, num_heads, head_dim, n_valid, want_lse=True)
        require(out, "out", qkv.dtype, dev, (b, n, d), align=16)
        require(lse, "lse", torch.float32, dev, (b, num_heads, n))
        # pass 1 -> pass 2: each row's rowsum(do * o), and q scaled in bf16
        dsum = torch.empty((b, num_heads, n), dtype=torch.float32, device=dev)
        qsc = torch.empty((b, n, d), dtype=qkv.dtype, device=dev)
        _build.load().call(
            "qvt_attention_long_bwd_mma", ptr(qkv), ptr(out), ptr(do), ptr(lse), ptr(dsum),
            ptr(qsc), ptr(dqkv), b, n, num_heads, head_dim, n_valid, qscale, scale,
            stream_of(dev))
    else:  # kernel B's f32 passes: each row's max, f64 softmax sum and rowsum between
        stats = torch.empty((3, b, num_heads, n), dtype=torch.float64, device=dev)
        lib, stream = _build.load(), stream_of(dev)
        for entry in ("qvt_attention_long_bwd_rows", "qvt_attention_long_bwd_keys"):
            lib.call(entry, ptr(qkv), ptr(do), ptr(stats), ptr(dqkv), b, n, num_heads,
                     head_dim, n_valid, qscale, scale, stream)
    long_attention_bwd.launches += 2  # the rows pass and the keys pass
    return dqkv


long_attention_bwd.launches = 0


def long_attention_f64(qkv: torch.Tensor, num_heads: int, head_dim: int,
                       do: torch.Tensor = None, *, n_valid: int = None, qs=None, in_fq=None):
    """The exact math, the yardstick of the tensor-core attentions'
    tolerance: attention over ``qkv``'s values in f64 (scores times
    ``hd**-0.5``, keys ``>= n_valid`` masked) and, with ``do``, its autograd
    gradient w.r.t. ``qkv`` for that cotangent (rows ``>= n_valid`` taken as
    zero), one image at a time → (out, dqkv or None), both f64. With
    ``in_fq=(qmin, qmax)`` the values are those of the qkv fake-quantized
    with ``qs``, as kernels A and B round them, and dqkv is the gradient at
    those values times the straight-through estimator's mask of the raw
    qkv. Neither depends on where a kernel applies the score scale, so one
    reference serves K5b and kernel B."""
    keep = None
    if in_fq is not None:
        keep = ste_mask(qkv, qs[0], qs[1], in_fq[0], in_fq[1]) if do is not None else None
        qkv = fake_quantize_values(qkv, qs[0], qs[1], in_fq[0], in_fq[1])
    b, n, _ = qkv.shape
    d = num_heads * head_dim
    n_valid = n if n_valid is None else n_valid
    masked = torch.arange(n, device=qkv.device) >= n_valid
    outs, grads = [], []
    for i in range(b):
        x = qkv[i : i + 1].to(torch.float64).requires_grad_(do is not None)
        with torch.enable_grad():
            q, k, v = split_heads(x, num_heads, head_dim)
            s = (q @ k.transpose(-1, -2)) * head_dim ** -0.5
            o = torch.softmax(s.masked_fill(masked, float("-inf")), dim=-1) @ v
            o = o.transpose(1, 2).reshape(1, n, d)
            if do is not None:
                g = do[i : i + 1].to(torch.float64).masked_fill(masked[:, None], 0)
                grads.append(torch.autograd.grad(o, x, g)[0])
        outs.append(o.detach())
    if do is None:
        return torch.cat(outs), None
    dqkv = torch.cat(grads)
    return torch.cat(outs), dqkv if keep is None else dqkv * keep


# The bf16 pair's tolerance (its tensor cores sum in their own order, so it
# cannot replay its index-ordered plain versions): the forward within
# TC_ELEM·(1 + |plain|) element by element, each section of the backward
# (dq, dk, dv) within rel L2 TC_REL_L2 of the plain version, and every
# section's rel L2 to the f64 math at most TC_F64_RATIO times the plain
# version's own.
TC_ELEM, TC_REL_L2, TC_F64_RATIO = 2.0 ** -7, 1e-2, 2.0


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in f64."""
    return float((a.double() - b.double()).norm() / b.double().norm())


def tc_errors(got: torch.Tensor, plain: torch.Tensor, ref: torch.Tensor, sections: int):
    """A bf16-pair output ``got`` (``sections`` equal column blocks: 1 for
    the forward, 3 for dqkv) against its plain version ``plain`` and the
    f64 math ``ref`` (:func:`long_attention_f64`) → (within the tolerance
    above, one dict per section: ``label``, ``worst`` |diff| to plain,
    ``within`` (the share of elements within the element bound),
    ``rel`` (rel L2 to plain), ``f64`` and ``plain_f64`` (rel L2 of ``got``
    and of ``plain`` to ``ref``))."""
    if got.dtype != plain.dtype or got.shape != plain.shape:
        raise ValueError(f"kernel gives {got.dtype}{tuple(got.shape)}, "
                         f"plain {plain.dtype}{tuple(plain.shape)}")
    width = got.shape[-1] // sections
    labels = ("out",) if sections == 1 else ("dq", "dk", "dv")
    ok, errs = True, []
    for i, label in enumerate(labels):
        g, p, r = (t[..., i * width:(i + 1) * width] for t in (got, plain, ref))
        err = (g.float() - p.float()).abs()
        inside = err <= TC_ELEM * (1.0 + p.float().abs())
        # the share from exact counts: a device mean may round 1 to 1 - 2^-53
        e = {"label": label, "worst": float(err.max()),
             "within": int(inside.sum()) / inside.numel(),
             "rel": rel_l2(g, p), "f64": rel_l2(g, r), "plain_f64": rel_l2(p, r)}
        close = bool(inside.all()) if sections == 1 else e["rel"] <= TC_REL_L2
        ok = (ok and close and bool(torch.isfinite(g).all())
              and e["f64"] <= TC_F64_RATIO * e["plain_f64"])
        errs.append(e)
    return ok, errs


class _LongAttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, head_dim):
        ctx.geom = (num_heads, head_dim)
        if reference_on():
            ctx.bwd = long_attention_bwd_plain
            ctx.save_for_backward(qkv)
            return long_attention_qkv_plain(qkv, num_heads, head_dim)
        ctx.bwd = long_attention_bwd
        if use_plain(qkv) or qkv.dtype != torch.bfloat16:
            ctx.save_for_backward(qkv)
            return long_attention_qkv(qkv, num_heads, head_dim)
        out, lse = _attention_launch(qkv, num_heads, head_dim, None, want_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, *stats = ctx.saved_tensors
        stats = dict(zip(("out", "lse"), stats))
        return ctx.bwd(qkv, do.to(qkv.dtype).contiguous(), *ctx.geom, **stats), None, None


def long_attention_train(qkv: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """Long-sequence MHA over the packed qkv ``[B, N, 3·H·hd]`` → ``[B, N,
    H·hd]``, differentiable (K5a forward, K5b backward); the ``[B, H, N, N]``
    probabilities never exist in memory."""
    return _LongAttentionTrain.apply(qkv, num_heads, head_dim)
