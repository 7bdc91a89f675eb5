"""Operations and bytes of the model's work, and the card's peaks: the
yardstick's arithmetic, frozen here.

The kernel-level counts (``gemm_work``, ``ln_work``, ``attention_work``,
``roofline``, ``block_works``, ``chain_works``) are copied unchanged from
``chip_smoke.py``; the model-level counts below build on them. Bytes count
each input read once and each output written once.
"""

from __future__ import annotations

# H100 SXM dense peaks (NVIDIA's H100 data sheet): operations per second by
# type, and the device memory's bytes per second
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def gemm_work(m, k, n, out_bytes, extra_bytes=0):
    """An int8 GEMM [m, k] @ [k, n] with its int32 column sums, f32 bias and
    outputs of ``out_bytes`` per element (more inputs in ``extra_bytes``)."""
    return {"ops": 2 * m * k * n, "type": "int8",
            "bytes": m * k + k * n + 8 * n + m * n * out_bytes + extra_bytes}


def ln_work(m, n, in_bytes):
    """LayerNorm of [m, n] (~8 f32 operations per element) → int8."""
    return {"ops": 8 * m * n, "type": "f32", "bytes": m * n * in_bytes + m * n + 8 * n}


def attention_work(b, n, heads, hd, out_bytes=2, backward=False, in_bytes=2, op_type="bf16"):
    """Attention over the packed qkv (bf16 unless ``in_bytes`` says f32): 2
    products forward (4·N²·hd per head), 5 backward (s, dp, dq, dk, dv:
    10·N²·hd), at the rate of ``op_type`` (f32 products: the f32 rate)."""
    d = heads * hd
    if backward:  # qkv and do in, dqkv out, all of in_bytes
        return {"ops": 10 * b * heads * n * n * hd, "type": op_type,
                "bytes": in_bytes * (b * n * 3 * d + b * n * d + b * n * 3 * d)}
    return {"ops": 4 * b * heads * n * n * hd, "type": op_type,
            "bytes": in_bytes * b * n * 3 * d + out_bytes * b * n * d}


def roofline(*works):
    """(bound_ms, bound_by): the least time the card could take for the
    ``works`` together (operations of each type at its peak, one after
    another, against all their bytes)."""
    t_ops = sum(w["ops"] / PEAK_OPS[w["type"]] for w in works)
    t_bytes = sum(w["bytes"] for w in works) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def block_works(b, n, d, mlp, heads, hd):
    """The five stages of one K4 block (the chain's launches, or K9's
    stages): the qkv GEMM (bf16 out), the int8-out attention, proj and fc2
    RESID_LN_Q and fc1 GELU_Q."""
    m = b * n
    return [gemm_work(m, d, 3 * d, 2), attention_work(b, n, heads, hd, 1),
            gemm_work(m, d, d, 4 + 1, 2 * m * d + 8 * d), gemm_work(m, d, mlp, 1),
            gemm_work(m, mlp, d, 2 + 1, 4 * m * d + 8 * d)]


def chain_works(b, n, d, mlp, heads, hd, depth, patch_k, head_n=0):
    """The launches of one int8 forward through a K4 / K6 chain: the patch
    GEMM and entry LN, the blocks, and the head GEMM."""
    m = b * n
    works = [gemm_work(m - b, patch_k, d, 2), ln_work(m, d, 2)]
    works += block_works(b, n, d, mlp, heads, hd) * depth
    return works + ([gemm_work(b, d, head_n, 4)] if head_n else [])


# ---------------------------------------------------------------------------
# model-level counts (this file's own)
# ---------------------------------------------------------------------------

def vit_forward_flops(arch) -> int:
    """Floating-point operations (2 per multiply-add) of one image's
    forward: the patch, block and head GEMMs and the attention products."""
    n, d, mlp, p = arch.seq_len, arch.embed_dim, arch.mlp_dim, arch.patch_size
    gemms = 2 * (n - 1) * (3 * p * p) * d
    gemms += arch.depth * 2 * n * (d * 3 * d + d * d + 2 * d * mlp)
    attn = arch.depth * 4 * n * n * d
    head = 2 * d * arch.num_classes
    return gemms + attn + head


def train_step_least_s(arch, images: int) -> float:
    """The least time of the KD + QAT step's model work for ``images``:
    the student's forward and backward (3x the forward), all bf16."""
    return 3 * vit_forward_flops(arch) * images / PEAK_OPS["bf16"]


def attn_train_works(arch, b: int):
    """Kernel A's forward and kernel B's backward over a batch of ``b``."""
    n, h, hd = arch.seq_len, arch.num_heads, arch.head_dim
    return attention_work(b, n, h, hd, 2), attention_work(b, n, h, hd, backward=True)


def serve_chain_works(arch, b: int):
    """One int8 forward of ``b`` images through the block chain (K4 / K6)."""
    return chain_works(b, arch.seq_len, arch.embed_dim, arch.mlp_dim, arch.num_heads,
                       arch.head_dim, arch.depth, 3 * arch.patch_size ** 2, arch.num_classes)


def serve_gemm_works(arch, b: int):
    """The chain's int8 GEMMs alone (patch, the blocks' four, head)."""
    return [w for w in serve_chain_works(arch, b) if w["type"] == "int8"]


def serve_attention_works(arch, b: int):
    """The chain's attention stages alone (K3 / K6a, int8 out)."""
    return [attention_work(b, arch.seq_len, arch.num_heads, arch.head_dim, 1)] * arch.depth


def serve_least_s(arch, b: int) -> float:
    """The least time of one int8 serving forward's model work: each
    operation at its own type's peak (int8 GEMMs, bf16 attention, f32 LN)."""
    return sum(w["ops"] / PEAK_OPS[w["type"]] for w in serve_chain_works(arch, b))
