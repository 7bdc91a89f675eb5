"""Vision Transformer with fake-quant sites (port of ``qat_vit_tpu/models/vit.py``).

timm geometry (patch 16, cls token, learned position embeddings, pre-norm
blocks, GELU MLP ×4), NHWC images, the patch convolution as patch
extraction + one GEMM with patch rows in (ph, pw, c) order. With
``cfg.quant`` set, the fake-quant sites are those of torch ``prepare_qat``
on a timm ViT, as in the JAX package: every dense weight, the output of
every dense layer and LayerNorm, and the input stub.

Attention is the einsum path of the JAX module (``vit.py:373-388``), in
f32 as the JAX model computes under QAT; the training-only options
(``dtype``, ``fast_math``, the Pallas training kernels) and the OWLv2 ones
(``pre_norm``, bias-free patches, ``num_classes=0``) come with their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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
    act: str = "gelu"  # MLP activation: "gelu" (timm) or "quick_gelu" (CLIP)
    quant: Optional[QConfig] = None
    qat_wrapper: bool = True

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


def apply_act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(x)
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
    (the ``torch.ao.nn.qat.Linear`` + ``activation_post_process`` pair)."""

    def __init__(self, in_features: int, features: int, quant: Optional[QConfig],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.quant = quant
        self.weight = nn.Parameter(torch.empty(features, in_features))
        _trunc_normal_(self.weight, 0.02, generator)
        self.bias = nn.Parameter(torch.zeros(features))
        if quant is not None:
            self.weight_fq = FakeQuantizer(quant.weight)
            self.act_fq = FakeQuantizer(quant.activation)

    def forward(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        w = self.weight
        if self.quant is not None:
            w = self.weight_fq(w, observe=observe)
        y = F.linear(x, w, self.bias)
        if self.quant is not None:
            y = self.act_fq(y, observe=observe)
        return y


class QuantLayerNorm(nn.Module):
    """LayerNorm (float params and compute) with output fake-quant.

    Normalizes as flax's ``nn.LayerNorm`` does in the JAX model, so observer
    statistics match it: f32 statistics with the fast variance
    ``E[x²] − E[x]²`` (floored at 0) and the scale folded into the
    ``rsqrt`` factor, ``(x − μ)·(rsqrt(var + eps)·γ) + β``."""

    def __init__(self, dim: int, quant: Optional[QConfig], eps: float = 1e-6):
        super().__init__()
        self.ln = nn.LayerNorm(dim, eps=eps)
        self.act_fq = FakeQuantizer(quant.activation) if quant is not None else None

    def forward(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        x = x.to(torch.float32)
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.ln.eps) * self.ln.weight
        y = (x - mean) * mul + self.ln.bias
        if self.act_fq is not None:
            y = self.act_fq(y, observe=observe)
        return y


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, generator=None):
        super().__init__()
        self.patch_size = cfg.patch_size
        self.proj = QuantDense(cfg.patch_size * cfg.patch_size * 3, cfg.embed_dim,
                               cfg.quant, generator)

    def forward(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        return self.proj(extract_patches(x, self.patch_size), observe=observe)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.qkv = QuantDense(d, 3 * d, cfg.quant, generator)
        self.proj = QuantDense(d, d, cfg.quant, generator)

    def forward(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        cfg = self.cfg
        b, n, d = x.shape
        h, hd = cfg.num_heads, cfg.head_dim
        qkv = self.qkv(x, observe=observe).reshape(b, n, 3, h, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q * hd**-0.5, k), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, d)
        return self.proj(out, observe=observe)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.fc1 = QuantDense(cfg.embed_dim, cfg.mlp_dim, cfg.quant, generator)
        self.fc2 = QuantDense(cfg.mlp_dim, cfg.embed_dim, cfg.quant, generator)

    def forward(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        y = apply_act(self.fc1(x, observe=observe), self.cfg.act)
        return self.fc2(y, observe=observe)


class Block(nn.Module):
    """Pre-norm block: x + Attn(LN(x)); x + MLP(LN(x))."""

    def __init__(self, cfg: ViTConfig, generator=None):
        super().__init__()
        eps, q = cfg.layer_norm_eps, cfg.quant
        self.norm1 = QuantLayerNorm(cfg.embed_dim, q, eps)
        self.attn = Attention(cfg, generator)
        self.norm2 = QuantLayerNorm(cfg.embed_dim, q, eps)
        self.mlp = Mlp(cfg, generator)

    def forward(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        x = x + self.attn(self.norm1(x, observe=observe), observe=observe)
        return x + self.mlp(self.norm2(x, observe=observe), observe=observe)


class VisionTransformer(nn.Module):
    """Quantizable ViT for classification: NHWC f32 images (preprocessed)
    → [B, num_classes] f32 logits.

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
        self.blocks = nn.ModuleList(Block(cfg, generator) for _ in range(cfg.depth))
        self.norm = QuantLayerNorm(d, q, cfg.layer_norm_eps)
        self.head = QuantDense(d, cfg.num_classes, q, generator)

    def forward(self, x: torch.Tensor, *, observe: bool = False) -> torch.Tensor:
        cfg = self.cfg
        if self.input_fq is not None:
            x = self.input_fq(x, observe=observe)
        x = self.patch_embed(x, observe=observe)
        b = x.shape[0]
        x = torch.cat([self.cls_token.expand(b, 1, cfg.embed_dim), x], dim=1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x, observe=observe)
        x = self.norm(x, observe=observe)
        return self.head(x[:, 0], observe=observe)


def count_fake_quant_sites(cfg: ViTConfig) -> dict:
    """Expected observer sites: 10 weight + 16 activation on a 2-block ViT,
    as torch ``prepare_qat`` creates them."""
    weights = 1 + 4 * cfg.depth + 1  # patch + (qkv, proj, fc1, fc2) per block + head
    acts = weights + 2 * cfg.depth + 1  # dense outputs + LN1/LN2 per block + final LN
    if cfg.qat_wrapper:
        acts += 1
    return {"weight": weights, "activation": acts}

