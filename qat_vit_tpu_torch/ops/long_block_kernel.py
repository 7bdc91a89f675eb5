"""The long-sequence int8 transformer stack (port of
``qat_vit_tpu/ops/long_block_kernel.py``, K6).

On the TPU one long-sequence block is ONE Pallas kernel (K6a,
``_long_block_kernel``) and the whole stack another (K6b,
``_long_model_kernel``, depth on the grid). On Hopper both are chains of
launches with K6's per-block contract (bf16 ``x`` and int8 ``zq`` in and
out, the 12-slot qparam table) and ``_long_block_impl``'s numerics, five
launches per block, as ``ops/block_kernel.py`` builds K4:

    qkv   int8_dense (PLAIN, bf16 out)                               K2a
          or, with int8_scores, int8_dense_q8 (PLAIN_Q8: + int8 q, k)
    attn  long_attention_q(out_q=qkv.out_q)    csrc/attention_long_q_mma.cu
          or, with int8_scores, long_attention_q8 (int8 score dots)
    proj  int8_dense_resid_ln_q (+x, LN2 → int8), x_mid f32 out      K2c
    fc1   int8_dense_gelu_q (quick-GELU or tanh-GELU → int8)         K2b
    fc2   int8_dense_resid_ln_q (+x_mid, next LN → int8), x bf16 out K2c

:func:`long_model_forward` loops :func:`long_block_forward`, so the two are
bit-identical by construction. The TPU kernels pad the sequence to a
multiple of lcm(q_tile, row_chunk, 128); the Hopper kernels take any N, so
:func:`long_megablock_pad` is the identity (padded keys would carry -1e30
and add exact zeros: the valid rows do not depend on padding). The TPU's
scheduling knobs (q_tile, row_chunk, stripe/chunk unroll, block_b) have no
counterpart. ``int8_scores`` (the ``i8`` serving flag) runs the same five
launches with the int8-score forms of the qkv and attention stages.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Tuple

import torch

from qat_vit_tpu_torch.ops import fused_serve as fs
from qat_vit_tpu_torch.ops.block_kernel import KERNEL_OPS, PLAIN_OPS, block_forward, block_tail
from qat_vit_tpu_torch.ops.fused_serve import gemm_shapes_ok
from qat_vit_tpu_torch.ops.long_attention import (
    long_attention_q8,
    long_attention_q8_plain,
    long_attention_qkv,
    long_attention_qkv_plain,
    long_attention_stream_ok,
)

# the ops the K6 chain runs: K4's, with the long-sequence attention, and the
# int8-score forms of the qkv and attention stages
LONG_KERNEL_OPS = SimpleNamespace(**{**vars(KERNEL_OPS), "attention": long_attention_qkv,
                                     "int8_dense_q8": fs.int8_dense_q8,
                                     "attention_q8": long_attention_q8})
LONG_PLAIN_OPS = SimpleNamespace(**{**vars(PLAIN_OPS), "attention": long_attention_qkv_plain,
                                    "int8_dense_q8": fs.int8_dense_q8_plain,
                                    "attention_q8": long_attention_q8_plain})


def long_megablock_pad(n: int, q_tile: int = 0, row_chunk: int = 0) -> int:
    """The sequence length the chain runs at: ``n`` (no padding on Hopper)."""
    del q_tile, row_chunk
    return n


def long_megablock_shapes_ok(n: int, num_heads: int, head_dim: int, mlp_dim: int) -> bool:
    """The chain's gate: the streaming attention kernel takes ``n`` at this
    head dim (any N at hd a multiple of 8 and <= 128), and the int8_gemm
    gates hold for every GEMM of the block."""
    d = num_heads * head_dim
    return (long_attention_stream_ok(n, head_dim) and gemm_shapes_ok(d, 3 * d)
            and gemm_shapes_ok(d, d, resid_ln=True) and gemm_shapes_ok(d, mlp_dim)
            and gemm_shapes_ok(mlp_dim, d, resid_ln=True))


def long_block_forward(
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
    ops: SimpleNamespace = LONG_KERNEL_OPS,
    int8_scores: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One long-sequence block (K6a) → (x', the next LN's int8 rows);
    ``int8_scores``: the attention's scores as int8 dots (JAX's option of
    the same name): the qkv GEMM also writes q and k on the qkv out_q grid
    and the attention takes its scores from them."""
    if not int8_scores:
        return block_forward(zq, x, blk, next_ln, num_heads=num_heads, head_dim=head_dim,
                             act=act, eps=eps, n_valid=n_valid, quant_max=quant_max, ops=ops)
    oq = blk["qkv"]["out_q"]
    qkv, qk8 = ops.int8_dense_q8(zq, blk["qkv"], blk["norm1"]["out_q"], oq, quant_max=quant_max)
    o_q = ops.attention_q8(qk8, qkv, num_heads, head_dim, out_q=oq, quant_max=quant_max,
                           n_valid=n_valid)
    return block_tail(o_q, x, blk, next_ln, act=act, eps=eps, quant_max=quant_max, ops=ops)


def long_model_forward(
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
    ops: SimpleNamespace = LONG_KERNEL_OPS,
    int8_scores: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All ``depth`` long-sequence blocks (K6b) → (x_final, the final-LN'd
    int8 token rows)."""
    for i in range(depth):
        nxt = blocks[str(i + 1)]["norm1"] if i + 1 < depth else final_ln
        x, zq = long_block_forward(zq, x, blocks[str(i)], nxt, num_heads=num_heads,
                                   head_dim=head_dim, act=act, eps=eps, n_valid=n_valid,
                                   quant_max=quant_max, ops=ops, int8_scores=int8_scores)
    return x, zq
