"""The int8 transformer stack (port of ``qat_vit_tpu/ops/block_kernel.py::model_forward``).

On the TPU the whole stack is ONE Pallas kernel (K4, ``_model_kernel``).
On Hopper it is a chain of five launches per block, keeping K4's per-block
contract (bf16 ``x`` and int8 ``zq`` in and out) and ``_block_tile_body``'s
numerics (:func:`block_forward` is one block, :func:`model_forward` the stack):

    qkv   int8_dense (PLAIN, bf16 out)                    K2a
    attn  fused_attention_qkv(out_q=qkv.out_q)            K3
    proj  int8_dense_resid_ln_q (+x, LN2 → int8), x_mid f32 out    K2c
    fc1   int8_dense_gelu_q (tanh-GELU or quick-GELU → int8)   K2b
    fc2   int8_dense_resid_ln_q (+x_mid, next LN → int8), x bf16 out  K2c

The residual ``x_mid`` stays f32 between proj and fc2 and ``x`` is rounded
to the stream dtype only at the block boundary, as in the TPU kernel. The
12-entry qparams table of each block is computed as the JAX package does
(``block_kernel.py:593-606``), including the fc1/fc2 input scales recomputed
as ``1/(1/s)`` in f32.

The same five stages also run inside ONE cooperative launch
(``csrc/megablock.cu``), the port of the TPU's whole-block kernels:

- :func:`megablock_forward` (K9a, ``_block_kernel``): one block per launch;
- :func:`megamodel_res_forward` (K9b, ``_model_resident_kernel``): every
  block in one launch, weights kept in L2 (:func:`model_forward` with
  ``resident=True``); gated on the stacked int8 weight bytes.

Both run the chain kernels' own stage code (the wgmma GEMM of K2a / K2b,
K2c's RESID_LN_Q row tile, K3's tensor-core attention tile) behind grid
barriers, so their x and zq are bit-identical to the kernel chain's; their
plain versions are the chain through the plain ops (K3's tensor-core sums
differ from its plain version's, so the kernels equal that plain chain only
with K3 as its attention stage).
The TPU's ``block_b`` (images per grid step) and sequence padding change
nothing here: the kernels take the unpadded N, and padded keys would get
exactly zero probability, so valid rows are the same either way.
"""

from __future__ import annotations

import ctypes
import struct
from types import SimpleNamespace
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops import fused_serve as fs
from qat_vit_tpu_torch.ops._cuda import SMEM_LIMIT, ptr, require, stream_of, use_plain
from qat_vit_tpu_torch.ops.flash_attention import (
    _q_scale,
    attention_fwd_shapes_ok,
    fused_attention_qkv,
    fused_attention_qkv_plain,
)
from qat_vit_tpu_torch.ops.quantized_matmul import f32, is_per_channel

# the ops model_forward chains: the kernel wrappers, or their plain versions
KERNEL_OPS = SimpleNamespace(
    int8_dense=fs.int8_dense, int8_dense_gelu_q=fs.int8_dense_gelu_q,
    int8_dense_resid_ln_q=fs.int8_dense_resid_ln_q, ln_quantize=fs.ln_quantize,
    attention=fused_attention_qkv,
)
PLAIN_OPS = SimpleNamespace(
    int8_dense=fs.int8_dense_plain, int8_dense_gelu_q=fs.int8_dense_gelu_q_plain,
    int8_dense_resid_ln_q=fs.int8_dense_resid_ln_q_plain, ln_quantize=fs.ln_quantize_plain,
    attention=fused_attention_qkv_plain,
)


def _recip_scale_q(out_q: Dict[str, Any]) -> Dict[str, float]:
    """``{"scale": 1/(1/s), "zero_point": zp}`` in f32: the dequant scale the
    TPU kernel derives from its table's ``inv_s`` slot."""
    inv = np.float32(1.0) / np.float32(f32(out_q["scale"]))
    return {"scale": float(np.float32(1.0) / inv), "zero_point": f32(out_q["zero_point"])}


def block_forward(
    zq: torch.Tensor,  # [B, N, D] shifted-int8 LN1 output of this block
    x: torch.Tensor,  # [B, N, D] residual stream (bf16)
    blk: Dict[str, Any],  # one entry of the convert_vit "blocks" tree
    next_ln: Dict[str, Any],  # the next block's norm1, or the final norm
    *,
    num_heads: int,
    head_dim: int,
    act: str = "gelu",
    eps: float = 1e-6,
    n_valid: int,
    quant_max: float = 255.0,
    ops: SimpleNamespace = KERNEL_OPS,
    block_b: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block's five launches → (x', the next LN's int8 rows).
    ``block_b`` (the TPU's images per grid step) changes nothing here."""
    del block_b
    qkv = ops.int8_dense(zq, blk["qkv"], blk["norm1"]["out_q"], out_dtype=torch.bfloat16)
    o_q = ops.attention(qkv, num_heads, head_dim, out_q=blk["qkv"]["out_q"],
                        quant_max=quant_max, n_valid=n_valid)
    return block_tail(o_q, x, blk, next_ln, act=act, eps=eps, quant_max=quant_max, ops=ops)


def block_tail(
    o_q: torch.Tensor,  # [B, N, D] int8 attention output on the qkv out_q grid
    x: torch.Tensor,  # [B, N, D] residual stream (bf16)
    blk: Dict[str, Any],
    next_ln: Dict[str, Any],
    *,
    act: str,
    eps: float,
    quant_max: float,
    ops: SimpleNamespace,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A block's last three launches (proj, fc1, fc2) → (x', the next LN's
    int8 rows)."""
    x_mid, zq2 = ops.int8_dense_resid_ln_q(
        o_q, blk["proj"], blk["qkv"]["out_q"], x, blk["norm2"], blk["norm2"]["out_q"],
        eps=eps, out_dtype=torch.float32, quant_max=quant_max,
    )
    g_q = ops.int8_dense_gelu_q(zq2, blk["fc1"], _recip_scale_q(blk["norm2"]["out_q"]),
                                blk["gelu_q"], act=act, quant_max=quant_max)
    return ops.int8_dense_resid_ln_q(
        g_q, blk["fc2"], _recip_scale_q(blk["gelu_q"]), x_mid, next_ln, next_ln["out_q"],
        eps=eps, out_dtype=x.dtype, quant_max=quant_max,
    )


def model_forward(
    zq: torch.Tensor,  # [B, N, D] shifted-int8 LN1 output of block 0
    x: torch.Tensor,  # [B, N, D] residual stream (bf16)
    blocks: Dict[str, Any],  # the convert_vit "blocks" tree (str(i) keys)
    final_ln: Dict[str, Any],  # the model's final norm entry
    *,
    num_heads: int,
    head_dim: int,
    depth: int,
    act: str = "gelu",
    eps: float = 1e-6,
    n_valid: int,
    quant_max: float = 255.0,
    ops: SimpleNamespace = KERNEL_OPS,
    block_b: int = 4,
    resident: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All ``depth`` blocks → (x_final, the final-LN'd int8 rows for the head).

    ``n_valid`` < N marks padded rows: their keys are masked in attention.
    ``resident=True`` runs the stack as ONE launch (K9b,
    :func:`megamodel_res_forward`; through ``PLAIN_OPS``, its plain
    version, the chain); tanh-GELU only, as on the TPU. ``block_b`` changes
    nothing here."""
    if resident:
        if act != "gelu":
            raise NotImplementedError(f"megamodel_res computes tanh-GELU in-kernel (act={act!r})")
        fn = megamodel_res_forward_plain if ops is PLAIN_OPS else megamodel_res_forward
        return fn(zq, x, blocks, final_ln, num_heads=num_heads, head_dim=head_dim, depth=depth,
                  eps=eps, n_valid=n_valid, quant_max=quant_max)
    for i in range(depth):
        nxt = blocks[str(i + 1)]["norm1"] if i + 1 < depth else final_ln
        x, zq = block_forward(zq, x, blocks[str(i)], nxt, num_heads=num_heads,
                              head_dim=head_dim, act=act, eps=eps, n_valid=n_valid,
                              quant_max=quant_max, ops=ops)
    return x, zq


# ---------------------------------------------------------------------------
# K9a / K9b: the five stages in one cooperative launch (csrc/megablock.cu)
# ---------------------------------------------------------------------------

# K9b keeps the stacked int8 weights in the H100's 50 MB L2 (ViT-S: 21.2 MB);
# above this, the stack takes the megamodel chain
MEGAMODEL_RES_MAX_WEIGHT_BYTES = 40 * 2 ** 20
# csrc/megablock.cu BlockTable (512 bytes, 64-byte aligned): the tensor maps
# of the packed qkv and fc1 weights (2 x 128 bytes, encoded by
# qvt_megablock_weight_map), then 20 pointers, ws0[4], ws_pc[4], s_x[4],
# z_s[4] and the 8 output grids (inv_so, zp_o, inv_s2, zp_2, inv_sg, zp_g,
# inv_sn, zp_n)
_MAP_BYTES = 128
_BLOCK_TABLE = struct.Struct("<20Q4f4i4f4i8f")
BLOCK_TABLE_BYTES = 2 * _MAP_BYTES + _BLOCK_TABLE.size

# csrc/megablock.cu's block shape: the wgmma GEMM's narrow form (2 consumer
# warpgroups of 64 rows; thread 0 fills the ring), a ring of K9_STAGES stages
# of (128 + 128) x 128 bytes, at most K9_MIN_BLOCKS blocks per SM
K9_CONSUMERS, K9_STAGES, K9_MIN_BLOCKS = 2, 4, 1
K9_THREADS = 128 * K9_CONSUMERS
K9_TILE_ROWS, K9_TILE_COLS, K9_K_BYTES = 64 * K9_CONSUMERS, 128, 128
ATTN_ROWS = 128  # K3's query rows per tile (csrc/attention_q_mma.cuh)
_ALIGN = 1024  # the slack that aligns the ring to 1024 bytes


def _gemm_region() -> int:
    """The wgmma stages' shared memory: the ring, then per consumer
    warpgroup the qkv stage's bf16 staging tile (64 rows of 128 x 2 + 16
    bytes) and the per-column constants (3 x 4 x 128 bytes)."""
    ring = K9_STAGES * (K9_TILE_ROWS + K9_TILE_COLS) * K9_K_BYTES
    return ring + K9_CONSUMERS * (64 * (K9_TILE_COLS * 2 + 16) + 3 * 4 * K9_TILE_COLS)


def _attention_bytes(n: int, head_dim: int, resident: bool) -> int:
    """K3's tile (``csrc/attention_q_mma.cuh``): K and V of the head resident
    (rows: n rounded up to 16, at least 128) or streamed (the q rows and
    3 (hd <= 64) or 2 stages of 64-key K and V tiles), bf16 rows of hdp + 8."""
    hdp = 64 if head_dim <= 64 else 128
    row = 2 * (hdp + 8)
    if resident:
        return 2 * row * max(-(-n // 16) * 16, ATTN_ROWS)
    return row * (ATTN_ROWS + 2 * (3 if hdp == 64 else 2) * 64)


def megablock_plan(n: int, d: int, head_dim: int) -> Tuple[int, bool, int, int]:
    """``csrc/megablock.cu``'s ``plan``: (K2c's rows per tile, K3 resident,
    the stages' common region, the block's dynamic shared memory). Within
    the GEMM stages' region K2c takes the most rows of 64, 32 and 16 that
    fit (16 where none does) and K3 keeps K and V resident, else streams
    them."""
    gemm = _gemm_region()
    rows = max([r for r in (32, 64) if fs.resid_ln_smem_bytes(r, d) <= gemm], default=16)
    resident = _attention_bytes(n, head_dim, True) <= gemm
    region = max(gemm, fs.resid_ln_smem_bytes(rows, d), _attention_bytes(n, head_dim, resident))
    region = -(-region // 16) * 16
    return rows, resident, region, _ALIGN + region + 2 * 8 * K9_STAGES


def megablock_shapes_ok(n: int, num_heads: int, head_dim: int, mlp_dim: int) -> bool:
    """K9's gate: the chain kernels' own gates (every GEMM's K a multiple of
    16, RESID_LN_Q's N within its plan; K3's hd a multiple of 8 up to 128,
    any N) and the stages' shared memory within the limit."""
    d = num_heads * head_dim
    return (fs.gemm_shapes_ok(d, 3 * d) and fs.gemm_shapes_ok(d, d, resid_ln=True)
            and fs.gemm_shapes_ok(d, mlp_dim) and fs.gemm_shapes_ok(mlp_dim, d, resid_ln=True)
            and attention_fwd_shapes_ok(n, head_dim)
            and megablock_plan(n, d, head_dim)[3] <= SMEM_LIMIT)


def stacked_weight_bytes(blocks: Dict[str, Any], depth: int) -> int:
    """The int8 weight bytes of ``depth`` blocks (qkv, proj, fc1, fc2)."""
    return sum(blocks[str(i)][g]["w_int8"].numel()
               for i in range(depth) for g in ("qkv", "proj", "fc1", "fc2"))


def _gemm_entry(layer: Dict[str, Any], in_q: Dict[str, Any], k: int, n: int, dev):
    w, cs, bias, ws = layer.get("w_int8_t"), layer["w_colsum"], layer.get("bias"), layer["w_scale"]
    if w is None:
        raise ValueError("megablock: the layer has no packed weight w_int8_t "
                         "(serve.int8_vit.export_to_device or fs.with_packed_weight adds it)")
    require(w, "w_int8_t", torch.int8, dev, (n, k), align=16)
    require(cs, "w_colsum", torch.int32, dev, (n,))
    if bias is not None:
        require(bias, "bias", torch.float32, dev, (n,))
    if is_per_channel(ws):
        require(ws, "w_scale", torch.float32, dev, (n,))
        ws_ptr, ws0, pc = ws.data_ptr(), 0.0, 1
    else:
        ws_ptr, ws0, pc = 0, f32(ws), 0
    ptrs = (w.data_ptr(), cs.data_ptr(), ptr(bias) or 0, ws_ptr)
    return ptrs, ws0, pc, f32(in_q["scale"]), int(f32(in_q["zero_point"])) - 128


def _block_table(blk: Dict[str, Any], next_ln: Dict[str, Any], d: int, mlp: int, dev,
                 lib) -> bytes:
    """One BlockTable record: the packed qkv and fc1 weights' tensor maps
    (encoded by ``lib``), then the parameters the chain's five launches get."""
    gemms = [
        _gemm_entry(blk["qkv"], blk["norm1"]["out_q"], d, 3 * d, dev),
        _gemm_entry(blk["proj"], blk["qkv"]["out_q"], d, d, dev),
        _gemm_entry(blk["fc1"], _recip_scale_q(blk["norm2"]["out_q"]), d, mlp, dev),
        _gemm_entry(blk["fc2"], _recip_scale_q(blk["gelu_q"]), mlp, d, dev),
    ]
    lns = []
    for ln in (blk["norm2"], next_ln):
        for key in ("scale", "bias"):
            require(ln[key], f"ln {key}", torch.float32, dev, (d,))
            lns.append(ln[key].data_ptr())
    grids = []
    for q in (blk["qkv"]["out_q"], blk["norm2"]["out_q"], blk["gelu_q"], next_ln["out_q"]):
        grids += [fs.inv_scale(q["scale"]), f32(q["zero_point"])]
    maps = (ctypes.c_char * (2 * _MAP_BYTES))()
    for i, rows in enumerate((3 * d, mlp)):  # qkv's and fc1's packed weights
        lib.call("qvt_megablock_weight_map", gemms[2 * i][0][0], rows, d,
                 ctypes.addressof(maps) + i * _MAP_BYTES)
    return maps.raw + _BLOCK_TABLE.pack(
        *[p for g in gemms for p in g[0]], *lns,
        *[g[1] for g in gemms], *[g[2] for g in gemms], *[g[3] for g in gemms],
        *[g[4] for g in gemms], *grids)


def _upload(data: bytes, dev) -> torch.Tensor:
    """``data`` on ``dev``, through pinned memory."""
    host = torch.frombuffer(bytearray(data), dtype=torch.uint8).pin_memory()
    return host.to(dev, non_blocking=True)


def _launch_megablock(zq, x, pairs: List[Tuple[Dict, Dict]], *, num_heads, head_dim, eps,
                      n_valid, quant_max, name: str):
    """One cooperative launch over ``pairs`` = [(block, next LN), ...] →
    (x', zq'); the activations between stages in one workspace."""
    dev = zq.device
    b, n, d = zq.shape
    mlp = pairs[0][0]["fc1"]["w_int8"].shape[1]
    if d != num_heads * head_dim:
        raise ValueError(f"{name}: D {d} != {num_heads} x {head_dim}")
    if not megablock_shapes_ok(n, num_heads, head_dim, mlp):
        raise ValueError(f"{name}: unsupported N={n}, D={d}, head_dim={head_dim}, MLP={mlp} "
                         f"(int8_gemm / attention_q gates, {megablock_plan(n, d, head_dim)[3]} "
                         f"bytes of shared memory <= {SMEM_LIMIT})")
    if not 0 < n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside (0, {n}]")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x must be bf16 or f32, not {x.dtype}")
    require(zq, "zq", torch.int8, dev, (b, n, d), align=16)
    require(x, "x", x.dtype, dev, (b, n, d))
    lib = _build.load()
    table = _upload(b"".join(_block_table(blk, nxt, d, mlp, dev, lib) for blk, nxt in pairs),
                    dev)
    x_out, zq_out = torch.empty_like(x), torch.empty_like(zq)
    m = b * n
    sizes = (m * 3 * d * 2, m * d, m * d * 4, m * d, m * mlp)  # qkv, o_q, x_mid, zq2, g_q
    offsets = np.cumsum((0,) + tuple(-(-s // 256) * 256 for s in sizes))
    ws = torch.empty(int(offsets[-1]), dtype=torch.uint8, device=dev)
    if b:
        lib.call(
            "qvt_megablock", ptr(table), len(pairs), ptr(zq), ptr(x), ptr(zq_out), ptr(x_out),
            *[ws.data_ptr() + int(o) for o in offsets[:5]], b, n, num_heads, head_dim, mlp,
            n_valid, int(x.dtype == torch.bfloat16),
            float(_q_scale(head_dim, torch.bfloat16)), f32(quant_max), float(eps), stream_of(dev),
        )
    return x_out, zq_out


def megablock_forward_plain(zq, x, blk, next_ln, *, num_heads, head_dim, eps=1e-6, n_valid,
                            quant_max=255.0):
    """K9a's plain version: the K4 block chain through the plain ops."""
    return block_forward(zq, x, blk, next_ln, num_heads=num_heads, head_dim=head_dim,
                         eps=eps, n_valid=n_valid, quant_max=quant_max, ops=PLAIN_OPS)


def megablock_forward(
    zq: torch.Tensor,  # [B, N, D] shifted-int8 LN1 output of this block
    x: torch.Tensor,  # [B, N, D] residual stream (bf16 or f32)
    blk: Dict[str, Any],
    next_ln: Dict[str, Any],
    *,
    num_heads: int,
    head_dim: int,
    eps: float = 1e-6,
    n_valid: int,
    quant_max: float = 255.0,
    block_b: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ViT block (tanh-GELU) in ONE cooperative launch (K9a) → (x', zq').
    ``block_b`` (the TPU's images per grid step) changes nothing here."""
    del block_b
    kw = dict(num_heads=num_heads, head_dim=head_dim, eps=eps, n_valid=n_valid,
              quant_max=quant_max)
    if use_plain(zq):
        return megablock_forward_plain(zq, x, blk, next_ln, **kw)
    out = _launch_megablock(zq, x, [(blk, next_ln)], name="megablock", **kw)
    megablock_forward.launches += int(zq.shape[0] > 0)
    return out


def megamodel_res_forward_plain(zq, x, blocks, final_ln, *, num_heads, head_dim, depth,
                                eps=1e-6, n_valid, quant_max=255.0):
    """K9b's plain version: the K4 chain through the plain ops."""
    return model_forward(zq, x, blocks, final_ln, num_heads=num_heads, head_dim=head_dim,
                         depth=depth, eps=eps, n_valid=n_valid, quant_max=quant_max,
                         ops=PLAIN_OPS)


def megamodel_res_forward(
    zq: torch.Tensor,
    x: torch.Tensor,
    blocks: Dict[str, Any],
    final_ln: Dict[str, Any],
    *,
    num_heads: int,
    head_dim: int,
    depth: int,
    eps: float = 1e-6,
    n_valid: int,
    quant_max: float = 255.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All ``depth`` blocks (tanh-GELU) in ONE cooperative launch (K9b),
    the stacked int8 weights re-read from L2 by every block → (x_final,
    zq_final).
    Raises, naming ``megamodel``, when the stacked int8 weights exceed
    :data:`MEGAMODEL_RES_MAX_WEIGHT_BYTES`."""
    kw = dict(num_heads=num_heads, head_dim=head_dim, eps=eps, n_valid=n_valid,
              quant_max=quant_max)
    if use_plain(zq):
        return megamodel_res_forward_plain(zq, x, blocks, final_ln, depth=depth, **kw)
    wbytes = stacked_weight_bytes(blocks, depth)
    if wbytes > MEGAMODEL_RES_MAX_WEIGHT_BYTES:
        raise NotImplementedError(
            f"megamodel_res keeps the stacked int8 weights in L2: {wbytes / 2 ** 20:.1f} MiB > "
            f"{MEGAMODEL_RES_MAX_WEIGHT_BYTES / 2 ** 20:.0f} MiB; serve this model with "
            "fused='megamodel'")
    pairs = [(blocks[str(i)], blocks[str(i + 1)]["norm1"] if i + 1 < depth else final_ln)
             for i in range(depth)]
    out = _launch_megablock(zq, x, pairs, name="megamodel_res", **kw)
    megamodel_res_forward.launches += int(zq.shape[0] > 0)
    return out


megablock_forward.launches = 0
megamodel_res_forward.launches = 0
