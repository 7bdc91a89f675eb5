"""OWLv2 open-vocabulary detection heads on the port's vision tower (port of
``qat_vit_tpu/models/owlv2_detect.py``).

HuggingFace's OWLv2 detection forward, as the JAX module computes it:

- merged feature map: patch tokens gated by the class token, then a
  LayerNorm (eps 1e-5, flax's fast variance);
- ``box_head``: a 3-layer erf-GELU MLP → per-patch (cx, cy, w, h) logits,
  plus :func:`box_bias`, through a sigmoid;
- ``class_proj`` → per-patch class embeddings; with query embeddings,
  cosine logits ``(logits + shift) · (elu(scale) + 1)``, ``finfo.min`` where
  ``query_mask`` is 0;
- ``objectness_head``: a 3-layer MLP on the detached features.

The tower is the port's ``VisionTransformer`` in feature mode
(``num_classes=0``), quantizable as in classification; the heads are float
(f32). Parameter names are the JAX module's (``vision``, ``merged_ln``,
``box_head``, ``objectness_head``, ``class_proj``, ``logit_shift``,
``logit_scale``), so ``models/jax_params.py`` carries weights across.
:func:`detection_heads` is the heads' forward as a function of their
parameters, shared by :class:`Owlv2Detector` and the int8 serving path.
:func:`owlv2_detection_to_params` converts an HF ``Owlv2ForObjectDetection``
state dict into the JAX package's detector tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qat_vit_tpu_torch.models.owlv2 import owlv2_vision_vit_kwargs
from qat_vit_tpu_torch.models.torch_convert import (
    as_numpy,
    normalize_state_dict_keys,
    owlv2_vision_to_params,
)
from qat_vit_tpu_torch.models.vit import (
    VisionTransformer,
    ViTConfig,
    _trunc_normal_,
    flax_layer_norm,
)
from qat_vit_tpu_torch.quant.qconfig import QConfig, default_qat_qconfig

MERGED_LN_EPS = 1e-5


def box_bias(num_patches_h: int, num_patches_w: int) -> torch.Tensor:
    """HF ``compute_box_bias``: the logit-space bias that anchors each
    patch's box centre at its grid position and its size at one patch → f32
    ``[P, 4]``."""
    xs = torch.arange(1, num_patches_w + 1, dtype=torch.float32) / num_patches_w
    ys = torch.arange(1, num_patches_h + 1, dtype=torch.float32) / num_patches_h
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.clamp(torch.stack([xx, yy], dim=-1).reshape(-1, 2), 0.0, 1.0)
    coord_bias = torch.log(coords + 1e-4) - torch.log1p(-coords + 1e-4)
    p = num_patches_h * num_patches_w
    size = torch.stack([torch.full((p,), 1.0 / num_patches_w),
                        torch.full((p,), 1.0 / num_patches_h)], dim=-1)
    size_bias = torch.log(size + 1e-4) - torch.log1p(-size + 1e-4)
    return torch.cat([coord_bias, size_bias], dim=-1)


def _dense_layer(in_dim: int, out_dim: int, generator) -> nn.Linear:
    """flax ``nn.Dense``'s init: lecun normal (truncated at ±2 std), zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    _trunc_normal_(layer.weight, (1.0 / in_dim) ** 0.5 / 0.8796256610342398, generator)
    nn.init.zeros_(layer.bias)
    return layer


class _MlpHead(nn.Module):
    """HF ``Owlv2BoxPredictionHead``: dense0 → GELU → dense1 → GELU → dense2."""

    def __init__(self, width: int, out_dim: int, generator=None):
        super().__init__()
        self.dense0 = _dense_layer(width, width, generator)
        self.dense1 = _dense_layer(width, width, generator)
        self.dense2 = _dense_layer(width, out_dim, generator)


def _dense(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _mlp(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
    # exact erf GELU in f32: the heads are float
    x = F.gelu(_dense(p, f"{name}.dense0", x))
    x = F.gelu(_dense(p, f"{name}.dense1", x))
    return _dense(p, f"{name}.dense2", x)


def detection_heads(
    heads: Dict[str, torch.Tensor],  # the heads' parameters, Owlv2Detector names
    tokens: torch.Tensor,  # [B, N, D] final-LN token stream of the tower
    grid: int,  # patches per side
    query_embeds: Optional[torch.Tensor] = None,  # [B, Q, text_dim]
    query_mask: Optional[torch.Tensor] = None,  # [B, Q], 1 = valid
) -> Dict[str, torch.Tensor]:
    """The float detection heads on a token stream → HF-shaped outputs:
    ``pred_boxes [B, P, 4]``, ``objectness_logits [B, P]``,
    ``class_embeds [B, P, text_dim]`` (L2-normalized on the query path),
    ``image_embeds [B, P, D]`` and, with queries, ``logits [B, P, Q]``."""
    tokens = tokens.to(torch.float32)
    feats = tokens[:, 1:, :] * tokens[:, :1, :]  # class-token gating
    feats = flax_layer_norm(feats, heads["merged_ln.weight"], heads["merged_ln.bias"],
                            MERGED_LN_EPS)
    obj = _mlp(heads, "objectness_head", feats.detach())[..., 0]
    boxes = _mlp(heads, "box_head", feats) + box_bias(grid, grid).to(feats.device)
    class_embeds = _dense(heads, "class_proj", feats)
    shift = _dense(heads, "logit_shift", feats)
    scale = F.elu(_dense(heads, "logit_scale", feats)) + 1.0
    out = {
        "image_embeds": feats,
        "class_embeds": class_embeds,
        "pred_boxes": torch.sigmoid(boxes),
        "objectness_logits": obj,
    }
    if query_embeds is not None:
        query_embeds = query_embeds.to(torch.float32)
        img_n = class_embeds / (torch.linalg.vector_norm(class_embeds, dim=-1, keepdim=True) + 1e-6)
        qry_n = query_embeds / (torch.linalg.vector_norm(query_embeds, dim=-1, keepdim=True) + 1e-6)
        out["class_embeds"] = img_n
        logits = (torch.einsum("bpd,bqd->bpq", img_n, qry_n) + shift) * scale
        if query_mask is not None:
            logits = torch.where(query_mask[:, None, :] == 0,
                                 torch.finfo(logits.dtype).min, logits)
        out["logits"] = logits
    return out


class Owlv2Detector(nn.Module):
    """OWLv2 detection forward on a quantizable vision tower (``cfg`` in
    feature mode)."""

    def __init__(self, cfg: ViTConfig, text_dim: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.num_classes != 0:
            raise ValueError("the detector's tower must be a feature extractor (num_classes=0)")
        self.cfg = cfg
        self.text_dim = text_dim
        d = cfg.embed_dim
        self.vision = VisionTransformer(cfg, generator)
        self.merged_ln = nn.LayerNorm(d, eps=MERGED_LN_EPS)
        self.objectness_head = _MlpHead(d, 1, generator)
        self.box_head = _MlpHead(d, 4, generator)
        self.class_proj = _dense_layer(d, text_dim, generator)
        self.logit_shift = _dense_layer(d, 1, generator)
        self.logit_scale = _dense_layer(d, 1, generator)

    def head_params(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.named_parameters() if not k.startswith("vision.")}

    def forward(self, pixels: torch.Tensor,
                query_embeds: Optional[torch.Tensor] = None,
                query_mask: Optional[torch.Tensor] = None, *,
                observe: bool = False) -> Dict[str, torch.Tensor]:
        return detection_heads(self.head_params(), self.vision(pixels, observe=observe),
                               self.cfg.image_size // self.cfg.patch_size,
                               query_embeds, query_mask)


def detector_config(pruned: bool = False, **overrides) -> ViTConfig:
    """The detector's tower config (feature mode)."""
    kw = owlv2_vision_vit_kwargs(pruned=pruned)
    kw.update(overrides)
    return ViTConfig(num_classes=0, **kw)


# ---------------------------------------------------------------------------
# HF checkpoint conversion: Owlv2ForObjectDetection state dict -> the JAX
# package's detector tree (vision tower via torch_convert.owlv2_vision_to_params)
# ---------------------------------------------------------------------------


def owlv2_detection_to_params(
    state: Mapping[str, Any], cfg: ViTConfig, text_dim: int = 512
) -> Dict[str, Any]:
    """Map a full HF ``Owlv2ForObjectDetection`` state dict onto the
    :class:`Owlv2Detector` tree of the JAX package (ref
    model_registry.py:269-327 constructs exactly this torch model); text-tower
    keys are dropped (queries enter as precomputed embeddings).
    ``models/jax_params.py`` loads the tree into the port's module."""
    vision = owlv2_vision_to_params(state, cfg, strict=False)
    norm = {
        (k[len("owlv2."):] if k.startswith("owlv2.") else k): as_numpy(v)
        for k, v in normalize_state_dict_keys(state).items()
    }

    def dense(prefix: str) -> Dict[str, np.ndarray]:
        return {
            "kernel": norm[f"{prefix}.weight"].T.astype(np.float32),
            "bias": norm[f"{prefix}.bias"].astype(np.float32),
        }

    def mlp(prefix: str) -> Dict[str, Any]:
        return {name: dense(f"{prefix}.{name}") for name in ("dense0", "dense1", "dense2")}

    params: Dict[str, Any] = {
        "vision": vision,
        "merged_ln": {
            "scale": norm["layer_norm.weight"].astype(np.float32),
            "bias": norm["layer_norm.bias"].astype(np.float32),
        },
        "box_head": mlp("box_head"),
        "class_proj": dense("class_head.dense0"),
        "logit_shift": dense("class_head.logit_shift"),
        "logit_scale": dense("class_head.logit_scale"),
    }
    if "objectness_head.dense0.weight" in norm:
        params["objectness_head"] = mlp("objectness_head")
    assert params["class_proj"]["kernel"].shape == (cfg.embed_dim, text_dim)
    return params


def create_detector(
    pruned: bool = False,
    qat_wrapper: bool = False,
    quant: Optional[QConfig] = None,
    text_dim: int = 512,
    generator: Optional[torch.Generator] = None,
    device=None,
    **overrides,
) -> Tuple[Owlv2Detector, ViTConfig]:
    """(module, cfg) of the OWLv2 detector. ``qat_wrapper=True`` arms the
    tower's fake-quant sites (qnnpack by default); the heads stay float.
    Built on the CPU, so a seed gives the same weights on every device."""
    if qat_wrapper and quant is None:
        quant = default_qat_qconfig("qnnpack")
    cfg = dataclasses.replace(detector_config(pruned=pruned, **overrides), quant=quant,
                              qat_wrapper=qat_wrapper)
    module = Owlv2Detector(cfg, text_dim=text_dim, generator=generator)
    if device is not None:
        module = module.to(device)
    return module, cfg
