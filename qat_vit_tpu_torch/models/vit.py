"""Vision Transformer with fake-quant sites (port of ``qat_vit_tpu/models/vit.py``).

timm geometry (patch 16, cls token, learned position embeddings, pre-norm
blocks, GELU MLP ×4), NHWC images, the patch convolution as patch
extraction + one GEMM with patch rows in (ph, pw, c) order. With
``cfg.quant`` set, the fake-quant sites are those of torch ``prepare_qat``
on a timm ViT, as in the JAX package: every dense weight, the output of
every dense layer and LayerNorm, and the input stub.

Training options, as the JAX module: ``dtype`` (the compute dtype; params
stay f32, fake-quant math stays f32, matmuls, bias adds and LayerNorm
outputs in ``dtype``, logits f32), ``fast_math`` (softmax in the compute
dtype, tanh-GELU), ``attn_kernel`` and ``fq_in_kernel`` (the attention
dispatch in :class:`Attention`: the hand-written attention kernels of
``ops/flash_attention_train.py`` and, for long sequences,
``ops/long_attention.py``, or the einsum path), ``remat`` (per-block
rematerialization when autograd records, ``ops/remat.py``). The CLIP-style
options of the OWLv2 vision tower, as the JAX module: ``pre_norm`` (a
LayerNorm after the position embedding), ``patch_bias=False`` and
``num_classes=0`` (feature mode: the f32 final-LN token stream, no head).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from qat_vit_tpu_torch.ops.flash_attention_train import (
    attention_train,
    attention_train_available,
    attention_train_fq,
)
from qat_vit_tpu_torch.ops.long_attention import (
    long_attention_train,
    long_attention_train_available,
)
from qat_vit_tpu_torch.ops.remat import REMAT_MODES, recompute
from qat_vit_tpu_torch.parallel.tensor import COLUMN, ROW, copy_to_model, reduce_from_model
from qat_vit_tpu_torch.quant.modules import FakeQuantizer
from qat_vit_tpu_torch.quant.qconfig import QConfig


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Static architecture + quantization configuration."""

    num_classes: int = 10
    image_size: int = 224
    patch_size: int = 16
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    # CLIP-style options (the OWLv2 vision tower)
    pre_norm: bool = False  # LN between the embeddings and the first block
    act: str = "gelu"  # MLP activation: "gelu" (timm) or "quick_gelu" (CLIP)
    patch_bias: bool = True  # timm's patch conv has a bias, CLIP's does not
    quant: Optional[QConfig] = None
    qat_wrapper: bool = True
    # compute dtype (params stay f32): bf16 in the trainer's amp / qat_amp phases
    dtype: torch.dtype = torch.float32
    # softmax in the compute dtype and tanh-GELU (the trainer's bf16 phases)
    fast_math: bool = False
    # permit the hand-written attention kernels (with fast_math, where they fit)
    attn_kernel: bool = True
    # per-block rematerialization under autograd (ops/remat.py): "none"
    # keeps every residual; "dots" keeps the GEMM products and the
    # attention's input and output and recomputes the elementwise chains
    # (Block.forward_dots); "full" recomputes the block from its input
    remat: str = "none"
    # the qkv activation fake-quant inside the attention kernels (training trace)
    fq_in_kernel: bool = False

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {self.remat!r}; expected one of {REMAT_MODES}")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(round(self.embed_dim * self.mlp_ratio))


VIT_TINY = dict(embed_dim=192, depth=12, num_heads=3)
VIT_SMALL = dict(embed_dim=384, depth=12, num_heads=6)
VIT_BASE = dict(embed_dim=768, depth=12, num_heads=12)
VIT_MICRO = dict(embed_dim=128, depth=2, num_heads=2, image_size=32, patch_size=8)


def flax_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm`` in f32: the fast variance ``E[x²] − E[x]²``
    (floored at 0) and the scale folded into the ``rsqrt`` factor,
    ``(x − μ)·(rsqrt(var + eps)·γ) + β``."""
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * weight) + bias


def apply_act(x: torch.Tensor, act: str, fast: bool = False) -> torch.Tensor:
    """MLP activation by name; ``fast=True`` is the tanh approximation in
    the compute dtype (``jax.nn.gelu(approximate=True)``)."""
    if act == "gelu":
        return F.gelu(x, approximate="tanh" if fast else "none")
    if act == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(f"unknown activation {act!r}")


def _trunc_normal_(t: torch.Tensor, std: float, generator: Optional[torch.Generator]):
    # the JAX package's truncated normal: cut at ±2 std
    with torch.no_grad():
        nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def extract_patches(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] → [B, gh·gw, p·p·C], rows in (ph, pw, c) order."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


class QuantDense(nn.Module):
    """``nn.Linear`` with weight fake-quant and output activation fake-quant
    (the ``torch.ao.nn.qat.Linear`` + ``activation_post_process`` pair).

    Fake-quant math runs in f32; the matmul and the bias add run in
    ``dtype``. ``defer_output_fq=True`` returns ``(y_raw, scale, zp)`` with
    the output observer updated, for a kernel that applies the fake-quant.

    Under a model axis (``parallel/tensor.shard_module``) ``tp`` is
    ``"column"`` (the weight holds this rank's output rows; the input's
    gradient is summed over ``tp_group``) or ``"row"`` (this rank's input
    columns; the partial product is summed over ``tp_group`` before the
    bias add and the output fake-quant)."""

    def __init__(self, in_features: int, features: int, quant: Optional[QConfig],
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, use_bias: bool = True):
        super().__init__()
        self.quant = quant
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        _trunc_normal_(self.weight, 0.02, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        if quant is not None:
            self.weight_fq = FakeQuantizer(quant.weight)
            self.act_fq = FakeQuantizer(quant.activation)
        self.tp: Optional[str] = None
        self.tp_group = None

    def forward(self, x: torch.Tensor, *, observe: bool = False,
                defer_output_fq: bool = False):
        return self.post(self.gemm(x, observe=observe), observe=observe,
                         defer_output_fq=defer_output_fq)

    def gemm(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        """The product alone: ``x @ fq(W)ᵀ`` in ``dtype``, no bias (under a
        model axis the whole product: a row-parallel one summed over the
        ranks)."""
        w = self.weight
        if self.quant is not None:
            w = self.weight_fq(w, observe=observe)
        if self.tp == COLUMN:
            x = copy_to_model(x, self.tp_group)
        y = F.linear(x.to(self.dtype), w.to(self.dtype))
        if self.tp == ROW:
            y = reduce_from_model(y, self.tp_group)
        return y

    def post(self, y: torch.Tensor, *, observe: bool = False, defer_output_fq: bool = False):
        """The bias add and the output fake-quant of :meth:`gemm`'s product."""
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        if self.quant is not None:
            return self.act_fq(y, observe=observe, apply_fq=not defer_output_fq)
        return y


class QuantLayerNorm(nn.Module):
    """LayerNorm (float params and compute) with output fake-quant.

    Normalizes as flax's ``nn.LayerNorm`` does in the JAX model
    (:func:`flax_layer_norm`), so observer statistics match it; the result
    is cast to ``dtype``, then fake-quantized."""

    def __init__(self, dim: int, quant: Optional[QConfig], eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ln = nn.LayerNorm(dim, eps=eps)
        self.act_fq = FakeQuantizer(quant.activation) if quant is not None else None

    def forward(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        y = flax_layer_norm(x, self.ln.weight, self.ln.bias, self.ln.eps).to(self.dtype)
        if self.act_fq is not None:
            y = self.act_fq(y, observe=observe)
        return y


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, generator=None):
        super().__init__()
        self.patch_size = cfg.patch_size
        self.proj = QuantDense(cfg.patch_size * cfg.patch_size * 3, cfg.embed_dim,
                               cfg.quant, generator, cfg.dtype, use_bias=cfg.patch_bias)

    def forward(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        return self.proj(extract_patches(x, self.patch_size), observe=observe)


class Attention(nn.Module):
    """timm-geometry MHA with quantizable qkv / proj GEMMs and the JAX
    module's dispatch (``vit.py:312-388``):

    - the qkv fake-quant inside the attention kernels
      (:func:`attention_train_fq`) when ``quant`` is set, ``fq_in_kernel``
      is on, the forward observes (the training trace) and the kernels fit;
    - :func:`attention_train` (kernels A + B) under ``fast_math`` and
      ``attn_kernel`` where they fit;
    - past their gates (long sequences: OWLv2's 2,305 tokens), the
      long-sequence pair :func:`long_attention_train` (K5a forward, K5b
      backward) under ``fast_math`` and ``attn_kernel`` where it fits, with
      the qkv fake-quant outside the kernels, as the JAX module's branch;
    - otherwise the einsum path: scores in the compute dtype, softmax in it
      under ``fast_math`` and in f32 otherwise.

    ``heads`` is the heads this module runs: all of ``cfg.num_heads``, or
    under a model axis this rank's (``parallel/tensor.shard_module``)."""

    def __init__(self, cfg: ViTConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.heads = cfg.num_heads
        d = cfg.embed_dim
        self.qkv = QuantDense(d, 3 * d, cfg.quant, generator, cfg.dtype)
        self.proj = QuantDense(d, d, cfg.quant, generator, cfg.dtype)

    def forward(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        route = self.route(x.shape[1], observe)
        qkv = self.qkv_out(self.qkv.gemm(x, observe=observe), observe=observe, route=route)
        return self.proj(self.mix(qkv, route), observe=observe)

    def route(self, n: int, observe) -> str:
        """The dispatch for ``n`` tokens: ``"fq"`` (kernels A + B with the
        qkv fake-quant inside), ``"kernel"`` (kernels A + B), ``"long"``
        (K5a + K5b) or ``"einsum"``."""
        cfg = self.cfg
        kernel_ok = (cfg.fast_math and cfg.attn_kernel
                     and attention_train_available(self.heads, cfg.head_dim, n, cfg.dtype))
        if cfg.quant is not None and cfg.fq_in_kernel and observe and kernel_ok:
            return "fq"
        if kernel_ok:
            return "kernel"
        if (cfg.fast_math and cfg.attn_kernel
                and long_attention_train_available(self.heads, cfg.head_dim, n, cfg.dtype)):
            return "long"
        return "einsum"

    def qkv_out(self, y: torch.Tensor, *, observe: bool = False, route: str):
        """The qkv GEMM's bias add and fake-quant: the activations, or on the
        ``"fq"`` route the pair (activations before the fake-quant, its
        ``[scale, zero_point]``) for the kernels to apply it."""
        if route != "fq":
            return self.qkv.post(y, observe=observe)
        qkv, scale, zp = self.qkv.post(y, observe=observe, defer_output_fq=True)
        return qkv, torch.stack([scale.to(torch.float32).reshape(()),
                                 zp.to(torch.float32).reshape(())])

    def mix(self, qkv, route: str) -> torch.Tensor:
        """Attention over :meth:`qkv_out`'s result on ``route``: ``[B, N, D]``."""
        cfg = self.cfg
        h, hd = self.heads, cfg.head_dim
        if route == "fq":
            act = cfg.quant.activation
            return attention_train_fq(qkv[0], qkv[1], h, hd, act.quant_min, act.quant_max)
        if route == "kernel":
            return attention_train(qkv, h, hd)
        if route == "long":
            return long_attention_train(qkv, h, hd)
        b, n, d3 = qkv.shape
        qkv = qkv.reshape(b, n, 3, h, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = torch.einsum("bqhd,bkhd->bhqk", q * hd**-0.5, k)
        sm_dtype = q.dtype if cfg.fast_math else torch.float32
        attn = torch.softmax(attn.to(sm_dtype), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, d3 // 3)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.fc1 = QuantDense(cfg.embed_dim, cfg.mlp_dim, cfg.quant, generator, cfg.dtype)
        self.fc2 = QuantDense(cfg.mlp_dim, cfg.embed_dim, cfg.quant, generator, cfg.dtype)

    def forward(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        return self.fc2.post(self.fc1_out_fc2_product(self.fc1.gemm(x, observe=observe),
                                                      observe=observe), observe=observe)

    def fc1_out_fc2_product(self, y: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        """fc1's bias add and fake-quant, the activation, fc2's product."""
        y = apply_act(self.fc1.post(y, observe=observe), self.cfg.act, fast=self.cfg.fast_math)
        return self.fc2.gemm(y, observe=observe)


class Block(nn.Module):
    """Pre-norm block: x + Attn(LN(x)); x + MLP(LN(x))."""

    def __init__(self, cfg: ViTConfig, generator=None):
        super().__init__()
        eps, q = cfg.layer_norm_eps, cfg.quant
        self.norm1 = QuantLayerNorm(cfg.embed_dim, q, eps, cfg.dtype)
        self.attn = Attention(cfg, generator)
        self.norm2 = QuantLayerNorm(cfg.embed_dim, q, eps, cfg.dtype)
        self.mlp = Mlp(cfg, generator)

    def forward(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        x = x + self.attn(self.norm1(x, observe=observe), observe=observe)
        return x + self.mlp(self.norm2(x, observe=observe), observe=observe)

    def forward_dots(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        """:meth:`forward` under ``remat="dots"``: the same ops in the same
        order, cut into functions that :func:`ops.remat.recompute` runs and
        that each end at a GEMM's product, the attention outside them. The
        backward keeps the block's input, the four products, the
        attention's input and output and the residual after it, and
        recomputes the elementwise chains in front of each product."""
        attn = self.attn
        route = attn.route(x.shape[1], observe)
        y = recompute(self._qkv_product, x, observe=observe)
        qkv = recompute(functools.partial(attn.qkv_out, route=route), y, observe=observe)
        y = recompute(attn.proj.gemm, attn.mix(qkv, route), observe=observe)
        x, y = recompute(self._fc1_product, x, y, observe=observe)
        y = recompute(self.mlp.fc1_out_fc2_product, y, observe=observe)
        return recompute(self._fc2_out, x, y, observe=observe)

    def _qkv_product(self, x, *, observe):
        return self.attn.qkv.gemm(self.norm1(x, observe=observe), observe=observe)

    def _fc1_product(self, x, y, *, observe):
        x = x + self.attn.proj.post(y, observe=observe)
        return x, self.mlp.fc1.gemm(self.norm2(x, observe=observe), observe=observe)

    def _fc2_out(self, x, y, *, observe):
        return x + self.mlp.fc2.post(y, observe=observe)


class VisionTransformer(nn.Module):
    """Quantizable ViT for classification: NHWC f32 images (preprocessed)
    → [B, num_classes] f32 logits; the token stream runs in ``cfg.dtype``.
    With ``num_classes=0`` (feature mode) there is no head and the output
    is the final-LN token stream ``[B, N, D]`` in f32.

    Random init from ``generator``: truncated normals (std 0.02, cls token
    1e-6) cut at ±2 std, zero biases, unit LayerNorm scales, as the JAX
    package initializes; the draws differ from ``jax.random``'s."""

    def __init__(self, cfg: ViTConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        q = cfg.quant
        self.input_fq = FakeQuantizer(q.activation) if q is not None and cfg.qat_wrapper else None
        self.patch_embed = PatchEmbed(cfg, generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        _trunc_normal_(self.cls_token, 1e-6, generator)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.seq_len, d))
        _trunc_normal_(self.pos_embed, 0.02, generator)
        self.norm_pre = QuantLayerNorm(d, q, cfg.layer_norm_eps, cfg.dtype) if cfg.pre_norm else None
        self.blocks = nn.ModuleList(Block(cfg, generator) for _ in range(cfg.depth))
        self.norm = QuantLayerNorm(d, q, cfg.layer_norm_eps, cfg.dtype)
        self.head = QuantDense(d, cfg.num_classes, q, generator, cfg.dtype) if cfg.num_classes else None

    def forward(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        cfg = self.cfg
        if self.input_fq is not None:
            x = self.input_fq(x, observe=observe)
        x = self.patch_embed(x, observe=observe)
        b = x.shape[0]
        cls = self.cls_token.to(x.dtype).expand(b, 1, cfg.embed_dim)
        x = (torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)).to(cfg.dtype)
        if self.norm_pre is not None:
            x = self.norm_pre(x, observe=observe)
        remat = cfg.remat if torch.is_grad_enabled() else "none"
        for blk in self.blocks:
            if remat == "dots":
                x = blk.forward_dots(x, observe=observe)
            elif remat == "full":
                x = recompute(blk, x, observe=observe)
            else:
                x = blk(x, observe=observe)
        x = self.norm(x, observe=observe)
        if self.head is None:
            return x.to(torch.float32)
        return self.head(x[:, 0], observe=observe).to(torch.float32)


def count_fake_quant_sites(cfg: ViTConfig) -> dict:
    """Expected observer sites: 10 weight + 16 activation on a 2-block ViT,
    as torch ``prepare_qat`` creates them; one activation site more with
    ``pre_norm``, one of each fewer in feature mode (no head)."""
    head = 1 if cfg.num_classes else 0
    weights = 1 + 4 * cfg.depth + head  # patch + (qkv, proj, fc1, fc2) per block + head
    acts = weights + 2 * cfg.depth + 1  # dense outputs + LN1/LN2 per block + final LN
    if cfg.pre_norm:
        acts += 1
    if cfg.qat_wrapper:
        acts += 1
    return {"weight": weights, "activation": acts}

