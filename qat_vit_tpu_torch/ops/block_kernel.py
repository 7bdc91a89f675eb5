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
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Tuple

import numpy as np
import torch

from qat_vit_tpu_torch.ops import fused_serve as fs
from qat_vit_tpu_torch.ops.flash_attention import (
    fused_attention_qkv,
    fused_attention_qkv_plain,
)
from qat_vit_tpu_torch.ops.quantized_matmul import f32

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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block's five launches → (x', the next LN's int8 rows)."""
    qkv = ops.int8_dense(zq, blk["qkv"], blk["norm1"]["out_q"], out_dtype=torch.bfloat16)
    o_q = ops.attention(qkv, num_heads, head_dim, out_q=blk["qkv"]["out_q"],
                        quant_max=quant_max, n_valid=n_valid)
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All ``depth`` blocks → (x_final, the final-LN'd int8 rows for the head).

    ``n_valid`` < N marks padded rows: their keys are masked in attention."""
    for i in range(depth):
        nxt = blocks[str(i + 1)]["norm1"] if i + 1 < depth else final_ln
        x, zq = block_forward(zq, x, blocks[str(i)], nxt, num_heads=num_heads,
                              head_dim=head_dim, act=act, eps=eps, n_valid=n_valid,
                              quant_max=quant_max, ops=ops)
    return x, zq
