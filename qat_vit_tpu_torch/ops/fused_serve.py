"""Fused int8 serving ops: GEMM + epilogue (port of ``qat_vit_tpu/ops/fused_serve.py``).

    int8_dense              x_q @ W  -> float             (K2a, PLAIN)
    int8_dense_q8           x_q @ W  -> (bf16, int8 of the q, k columns)   (PLAIN_Q8)
    int8_dense_gelu_q       x_q @ W  -> GELU -> int8      (K2b, GELU_Q)
    int8_dense_resid_ln_q   x_q @ W + residual -> (y, LN(y) -> int8)   (K2c)
    ln_quantize             LN(x) -> int8                 (K2d)

On CUDA the first four launch the ``int8_gemm`` kernels (PLAIN,
PLAIN_Q8 and GELU_Q: ``qvt_int8_gemm``, ``csrc/int8_gemm_wgmma.cu``, TMA
and wgmma; RESID_LN_Q: ``qvt_int8_gemm_resid_ln``, ``csrc/int8_gemm.cu``)
and the last the ``ln_quantize`` kernels (``csrc/ln_quantize.cu``: the
register form, or the strided form where the kernel's plan, mirrored by
:func:`ln_quantize_plan`, says so); on the CPU each runs its plain version (``*_plain``, same signature), which
``chip_smoke.py`` also runs on the card to check the kernels. Each wrapper
counts its kernel launches in ``<wrapper>.launches``.

Activations are shifted int8; ``in_q``/``out_q`` are ``{"scale",
"zero_point"}`` dicts of the export. Quantizing multiplies by ``1/scale``
(f32), as the TPU kernels do. ``W`` stays ``[K, N]`` as exported, for the
plain versions and the file format; the kernels (K7 and K9 too) read a
k-contiguous ``[N, K]`` copy, ``layer["w_int8_t"]`` (:func:`with_packed_weight`), which
``serve/int8_vit.export_to_device`` adds to every GEMM layer of an export
placed on a CUDA device; on CUDA a wrapper raises for a layer without one.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops._cuda import SMEM_LIMIT, ptr, require, stream_of, use_plain
from qat_vit_tpu_torch.ops.quantized_matmul import f32, int8_matmul, is_per_channel

EPI_PLAIN, EPI_GELU_Q, EPI_RESID_LN_Q, EPI_PLAIN_Q8 = 0, 1, 2, 3
_ACTS = {"gelu": 0, "quick_gelu": 1}
# the int8_gemm kernels read A [M, K] and the packed W [N, K] in 16-byte
# chunks (TMA's and cp.async's row stride), zero-filled past K
GEMM_K_MULTIPLE = 16
# the widest N of RESID_LN_Q (K2c, and K9's proj and fc2 stages): where the
# port's first RESID_LN_Q tile (32 rows x N f32 beside 96 rows of 80 bytes)
# set it; the pipelined plan below holds it at 16 rows per block
RESID_LN_MAX_N = 1756
# the pipelined RESID_LN_Q (K2c, qvt_int8_gemm_resid_ln): blocks of 64, 32
# or 16 rows x all N, column passes of 192, a ring of 3 stages of (A [rows
# x 64], B [192 x 64]) in rows of 64 + 16 bytes, the block's f32 y in rows of
# N + 4 and five f32 per-column constants
GEMM_ROW_BYTES = 80
RESID_LN_BLOCK_ROWS = (64, 32, 16)
RESID_LN_PASS_N, RESID_LN_STAGES = 192, 3
# H100: shared memory of an SM, and what the runtime reserves per block
SM_SMEM_BYTES, BLOCK_SMEM_RESERVE = 233472, 1024
# K2d's register form (csrc/ln_quantize.cu): the most row elements a lane
# holds (a warp holds its row: N up to 32 x 32 = 1,024), and the vector
# widths in bytes it loads, by element bytes (f32 rows take 16-byte vectors
# only, so that a lane stores at least 4 int8 bytes)
LN_REG_SLOTS = 32
LN_REG_VECS = {2: (16, 8), 4: (16,)}


def gemm_shapes_ok(k: int, n: int, resid_ln: bool = False) -> bool:
    """The int8_gemm kernels' shape gate: K a multiple of 16, any N (up to
    RESID_LN_MAX_N for RESID_LN_Q)."""
    return k > 0 and k % GEMM_K_MULTIPLE == 0 and n >= 1 and (not resid_ln or n <= RESID_LN_MAX_N)


def resid_ln_smem_bytes(rows: int, n: int) -> int:
    """Shared memory of the pipelined RESID_LN_Q at ``rows`` per block."""
    return (RESID_LN_STAGES * (rows + RESID_LN_PASS_N) * GEMM_ROW_BYTES
            + rows * (n + 4) * 4 + 5 * 4 * n)


def resid_ln_rows(m: int, n: int) -> int:
    """Rows per block of the pipelined RESID_LN_Q for ``[m, K] @ [K, n]``:
    of 64, 32 and 16, the height that keeps the most rows in flight on an
    SM (rows × the blocks whose shared memory fits an SM together, at most
    two), the shorter on a tie: W streams once per block, and a second
    block per SM hides the first one's load latency and epilogue. OWLv2's
    N 576 takes 64 rows (one block per SM), ViT-S's 384 takes 32 (two);
    measured on an H100 by ``port_scripts/k2c_variants.py``. Every ``n <=
    RESID_LN_MAX_N`` fits at 16. ``m`` does not enter."""
    del m
    best, best_rows = 0, None
    for r in sorted(RESID_LN_BLOCK_ROWS):
        smem = resid_ln_smem_bytes(r, n)
        if smem > SMEM_LIMIT:
            continue
        rows = r * min(2, SM_SMEM_BYTES // (smem + BLOCK_SMEM_RESERVE))
        if rows > best:
            best, best_rows = rows, r
    if best_rows is None:
        raise ValueError(f"RESID_LN_Q: N={n} past the shared-memory plan")
    return best_rows


@functools.lru_cache(maxsize=None)
def ln_quantize_plan(n: int, elem_bytes: int, align: int = 16) -> Tuple[int, int]:
    """K2d's form for a row of ``n`` elements of ``elem_bytes`` at a data
    pointer aligned to ``align`` bytes (at most 16): ``(vector bytes,
    vectors per lane)`` of the register form, a warp holding its row in
    registers, or ``(0, 0)`` for the strided form (N not a multiple of 4,
    N past ``LN_REG_SLOTS`` x 32, a row the vectors cannot take). Of the
    vector widths the row takes, the one whose lanes hold the fewest element
    slots, the wider on a tie. The mirror of ``ln_plan`` in
    ``csrc/ln_quantize.cu``, which picks the form on the card; the tests and
    ``chip_smoke.py`` read the form from here."""
    best, best_slots = (0, 0), LN_REG_SLOTS + 1
    if n <= 0 or n % 4:
        return best
    for vec in LN_REG_VECS[elem_bytes]:
        e = vec // elem_bytes
        if n % e or align % vec:
            continue
        nv = -(-(n // e) // 32)
        if nv * e < best_slots:
            best, best_slots = (vec, nv), nv * e
    return best if best_slots <= LN_REG_SLOTS else (0, 0)


def pointer_align(t: torch.Tensor) -> int:
    """The alignment of ``t``'s data pointer in bytes, at most 16."""
    p = t.data_ptr()
    return min(p & -p, 16) if p else 16


def pack_k_major(w_int8: torch.Tensor) -> torch.Tensor:
    """The ``[K, N]`` weight as a k-contiguous ``[N, K]`` copy."""
    return w_int8.t().contiguous()


def with_packed_weight(layer: dict) -> dict:
    """``layer`` with ``w_int8_t``, the k-contiguous copy the kernels read."""
    return {**layer, "w_int8_t": pack_k_major(layer["w_int8"])}


def inv_scale(scale) -> float:
    """``1/scale`` in f32, as the JAX package computes the kernels' ``inv_s``."""
    return float(np.float32(1.0) / np.float32(f32(scale)))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def quantize_mul(y: torch.Tensor, inv_s: float, zp: float, qmax: float) -> torch.Tensor:
    """``clamp(round(y * inv_s + zp), 0, qmax) - 128`` → int8 (the kernels' quantize)."""
    return (torch.clamp(torch.round(y * inv_s + zp), 0.0, qmax) - 128.0).to(torch.int8)


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(y, approximate=True)``, in its operation order."""
    k = float(np.float32(np.sqrt(2.0 / np.pi)))
    return y * (0.5 * (1.0 + torch.tanh(k * (y + 0.044715 * (y * y * y)))))


def layernorm_f32(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float):
    """LN over the last axis, f32 in and out: ``(y − μ)·rstd·γ + β``.

    μ and ``rstd = 1/sqrt(var + eps)`` (var = mean((y − μ)²)) are summed in
    f64 and rounded to f32 once, as the kernels' ``warp_row_stats`` does, so
    they do not depend on the summation order and kernel and plain version
    agree bit for bit; they stay within f32 rounding of the JAX kernels'
    f32 statistics."""
    y = y.to(torch.float32)
    y64 = y.to(torch.float64)
    mean = y64.mean(dim=-1, keepdim=True)
    var = torch.square(y64 - mean).mean(dim=-1, keepdim=True)
    rstd = (1.0 / torch.sqrt(var + float(np.float32(eps)))).to(torch.float32)
    return (y - mean.to(torch.float32)) * rstd * gamma.to(y.device) + beta.to(y.device)


def _dense_f32(x_q, layer, in_q) -> torch.Tensor:
    return int8_matmul(
        x_q, layer["w_int8"], x_scale=in_q["scale"], x_zero_point=in_q["zero_point"],
        w_scale=layer["w_scale"], w_colsum=layer["w_colsum"], bias=layer.get("bias"),
        out_dtype=torch.float32,
    )


def int8_dense_plain(x_q, layer, in_q, *, out_dtype=torch.bfloat16):
    return _dense_f32(x_q, layer, in_q).to(out_dtype)


def qk_cols(layer: dict) -> int:
    """The q and k columns of a packed qkv layer: the first two thirds."""
    n = layer["w_int8"].shape[-1]
    if n % 3:
        raise ValueError(f"int8_dense_q8: {n} output columns are not a packed q, k, v")
    return 2 * n // 3


def int8_dense_q8_plain(x_q, layer, in_q, out_q, *, quant_max=255.0):
    """``(y, q8)``: y in bf16, and the q and k columns of the f32 y (before
    that rounding) quantized on the ``out_q`` grid."""
    y = _dense_f32(x_q, layer, in_q)
    q8 = quantize_mul(y[..., :qk_cols(layer)], inv_scale(out_q["scale"]),
                      f32(out_q["zero_point"]), f32(quant_max))
    return y.to(torch.bfloat16), q8


def int8_dense_gelu_q_plain(x_q, layer, in_q, gelu_out_q, *, act="gelu", quant_max=255.0):
    y = _dense_f32(x_q, layer, in_q)
    g = y * torch.sigmoid(1.702 * y) if act == "quick_gelu" else gelu_tanh(y)
    return quantize_mul(g, inv_scale(gelu_out_q["scale"]), f32(gelu_out_q["zero_point"]),
                        f32(quant_max))


def int8_dense_resid_ln_q_plain(x_q, layer, in_q, residual, ln, ln_out_q, *, eps=1e-6,
                                out_dtype=torch.bfloat16, quant_max=255.0):
    y = _dense_f32(x_q, layer, in_q) + residual.to(torch.float32)
    z = layernorm_f32(y, ln["scale"], ln["bias"], eps)
    q = quantize_mul(z, inv_scale(ln_out_q["scale"]), f32(ln_out_q["zero_point"]),
                     f32(quant_max))
    return y.to(out_dtype), q


def ln_quantize_plain(x, ln, out_q, *, eps=1e-6, quant_max=255.0):
    z = layernorm_f32(x, ln["scale"], ln["bias"], eps)
    return quantize_mul(z, inv_scale(out_q["scale"]), f32(out_q["zero_point"]), f32(quant_max))


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _launch_gemm(epi: int, x_q: torch.Tensor, layer: dict, in_q: dict, *,
                 y_dtype: Optional[torch.dtype] = None,
                 residual: Optional[torch.Tensor] = None, ln: Optional[dict] = None,
                 out_q: Optional[dict] = None, act: str = "gelu", eps: float = 0.0,
                 quant_max=255.0,
                 q_cols: int = 0) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    dev = x_q.device
    w = layer["w_int8"]
    if w.ndim != 2:
        raise ValueError(f"w_int8: expected [K, N], got {tuple(w.shape)}")
    k, n = w.shape
    if not gemm_shapes_ok(k, n, epi == EPI_RESID_LN_Q):
        raise ValueError(f"int8_gemm: unsupported K={k}, N={n} (K % {GEMM_K_MULTIPLE}, "
                         f"N <= {RESID_LN_MAX_N} for RESID_LN_Q)")
    require(x_q, "x_q", torch.int8, dev, tuple(x_q.shape[:-1]) + (k,), align=16)
    m = x_q.numel() // k
    require(w, "w_int8", torch.int8, dev, (k, n), align=16)
    colsum = layer["w_colsum"]
    require(colsum, "w_colsum", torch.int32, dev, (n,))
    bias = layer.get("bias")
    if bias is not None:
        require(bias, "bias", torch.float32, dev, (n,))
    ws = layer["w_scale"]
    if is_per_channel(ws):
        require(ws, "w_scale", torch.float32, dev, (n,))
        ws_ptr, ws0, per_channel = ws.data_ptr(), 0.0, 1
    else:
        ws_ptr, ws0, per_channel = None, f32(ws), 0
    if y_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"int8_gemm writes f32 or bf16, not {y_dtype}")
    if epi == EPI_PLAIN_Q8 and not 0 < q_cols <= n:
        raise ValueError(f"int8_gemm PLAIN_Q8: q_cols {q_cols} outside (0, {n}]")
    q_n = q_cols if epi == EPI_PLAIN_Q8 else n
    w_t = layer.get("w_int8_t")
    if w_t is None:
        raise ValueError("int8_gemm: the layer has no packed weight w_int8_t "
                         "(serve.int8_vit.export_to_device or with_packed_weight adds it)")
    require(w_t, "w_int8_t", torch.int8, dev, (n, k), align=16)
    y = torch.empty((m, n), dtype=y_dtype, device=dev) if epi != EPI_GELU_Q else None
    q = torch.empty((m, q_n), dtype=torch.int8, device=dev) if epi != EPI_PLAIN else None
    gamma = beta = None
    res_bf16 = 0
    if epi == EPI_RESID_LN_Q:
        if residual is None or residual.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("residual: f32 or bf16 tensor required")
        require(residual, "residual", residual.dtype, dev, tuple(x_q.shape[:-1]) + (n,))
        res_bf16 = int(residual.dtype == torch.bfloat16)
        gamma, beta = ln["scale"], ln["bias"]
        require(gamma, "ln scale", torch.float32, dev, (n,))
        require(beta, "ln bias", torch.float32, dev, (n,))
    inv_s, zp = (inv_scale(out_q["scale"]), f32(out_q["zero_point"])) if out_q else (1.0, 0.0)
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if m and epi == EPI_RESID_LN_Q:
        _build.load().call(
            "qvt_int8_gemm_resid_ln", ptr(x_q), ptr(w_t), ptr(colsum), ptr(bias), ws_ptr,
            ptr(residual), ptr(gamma), ptr(beta), ptr(y), ptr(q), m, n, k, resid_ln_rows(m, n),
            int(y_dtype == torch.bfloat16), res_bf16, per_channel, ws0, f32(in_q["scale"]),
            int(f32(in_q["zero_point"])) - 128, inv_s, zp, f32(quant_max), float(eps),
            stream_of(dev),
        )
    elif m:
        _build.load().call(
            "qvt_int8_gemm", ptr(x_q), ptr(w_t), ptr(colsum), ptr(bias), ws_ptr, ptr(y), ptr(q),
            m, n, k, epi, int(y_dtype == torch.bfloat16), per_channel, _ACTS[act],
            ws0, f32(in_q["scale"]), int(f32(in_q["zero_point"])) - 128, inv_s, zp,
            f32(quant_max), q_n, stream_of(dev),
        )
    lead = tuple(x_q.shape[:-1])
    return (
        None if y is None else y.reshape(*lead, n),
        None if q is None else q.reshape(*lead, q_n),
    )


# ---------------------------------------------------------------------------
# public ops (leading dims preserved)
# ---------------------------------------------------------------------------

def int8_dense(x_q: torch.Tensor, layer: dict, in_q: dict, *,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    if use_plain(x_q):
        return int8_dense_plain(x_q, layer, in_q, out_dtype=out_dtype)
    y, _ = _launch_gemm(EPI_PLAIN, x_q, layer, in_q, y_dtype=out_dtype)
    int8_dense.launches += int(x_q.numel() > 0)
    return y


def int8_dense_q8(x_q: torch.Tensor, layer: dict, in_q: dict, out_q: dict, *,
                  quant_max=255.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, q8)``: the PLAIN output in bf16 and the q and k columns (the
    first two thirds) of the f32 y quantized on ``out_q`` (the qkv GEMM of
    K6's ``int8_scores``: q and k on the qkv out_q grid for the int8 score
    dots)."""
    if use_plain(x_q):
        return int8_dense_q8_plain(x_q, layer, in_q, out_q, quant_max=quant_max)
    y, q = _launch_gemm(EPI_PLAIN_Q8, x_q, layer, in_q, y_dtype=torch.bfloat16, out_q=out_q,
                        quant_max=quant_max, q_cols=qk_cols(layer))
    int8_dense_q8.launches += int(x_q.numel() > 0)
    return y, q


def int8_dense_gelu_q(x_q: torch.Tensor, layer: dict, in_q: dict, gelu_out_q: dict, *,
                      act: str = "gelu", quant_max=255.0) -> torch.Tensor:
    if use_plain(x_q):
        return int8_dense_gelu_q_plain(x_q, layer, in_q, gelu_out_q, act=act,
                                       quant_max=quant_max)
    _, q = _launch_gemm(EPI_GELU_Q, x_q, layer, in_q, out_q=gelu_out_q, act=act,
                        quant_max=quant_max)
    int8_dense_gelu_q.launches += int(x_q.numel() > 0)
    return q


def int8_dense_resid_ln_q(x_q: torch.Tensor, layer: dict, in_q: dict,
                          residual: torch.Tensor, ln: dict, ln_out_q: dict, *,
                          eps: float = 1e-6, out_dtype=torch.bfloat16,
                          quant_max=255.0) -> Tuple[torch.Tensor, torch.Tensor]:
    if use_plain(x_q):
        return int8_dense_resid_ln_q_plain(x_q, layer, in_q, residual, ln, ln_out_q,
                                           eps=eps, out_dtype=out_dtype,
                                           quant_max=quant_max)
    y, q = _launch_gemm(EPI_RESID_LN_Q, x_q, layer, in_q, y_dtype=out_dtype,
                        residual=residual, ln=ln, out_q=ln_out_q, eps=eps,
                        quant_max=quant_max)
    int8_dense_resid_ln_q.launches += int(x_q.numel() > 0)
    return y, q


def ln_quantize(x: torch.Tensor, ln: dict, out_q: dict, *, eps: float = 1e-6,
                quant_max=255.0) -> torch.Tensor:
    if use_plain(x):
        return ln_quantize_plain(x, ln, out_q, eps=eps, quant_max=quant_max)
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ln_quantize: x must be f32 or bf16, not {x.dtype}")
    n = x.shape[-1]
    require(x, "x", x.dtype, dev, tuple(x.shape))
    require(ln["scale"], "ln scale", torch.float32, dev, (n,))
    require(ln["bias"], "ln bias", torch.float32, dev, (n,))
    m = x.numel() // n
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    if m:
        _build.load().call(
            "qvt_ln_quantize", ptr(x), ptr(ln["scale"]), ptr(ln["bias"]), ptr(q), m, n,
            int(x.dtype == torch.bfloat16), inv_scale(out_q["scale"]),
            f32(out_q["zero_point"]), f32(quant_max), float(eps), stream_of(dev),
        )
        ln_quantize.launches += 1
    return q


for _wrapper in (int8_dense, int8_dense_q8, int8_dense_gelu_q, int8_dense_resid_ln_q, ln_quantize):
    _wrapper.launches = 0
del _wrapper
