"""OWLv2 detection family: the vision tower's geometry and the pruned
student's config surgery (port of ``qat_vit_tpu/models/owlv2.py``).

The published ``google/owlv2-base-patch16-ensemble`` geometry and the
reference's surgery rule (depth/width/head ratios, default 0.75, with
floors 6/384/6; student image size 768) are plain functions, copied as
they are. The HuggingFace construction (``build_owlv2_student_torch``)
needs ``transformers`` and is not part of the port (ROADMAP.md Queue 2).
"""

from __future__ import annotations

from typing import Dict

# Published geometry of google/owlv2-base-patch16-ensemble (vision tower).
OWLV2_BASE_VISION = dict(
    hidden_size=768,
    num_hidden_layers=12,
    num_attention_heads=12,
    intermediate_size=3072,
    image_size=960,
    patch_size=16,
)
OWLV2_BASE_TEXT = dict(
    hidden_size=512,
    num_hidden_layers=12,
    num_attention_heads=8,
    intermediate_size=2048,
)


def prune_owlv2_geometry(
    base: Dict[str, int],
    depth_ratio: float = 0.75,
    width_ratio: float = 0.75,
    head_ratio: float = 0.75,
    student_image_size: int = 768,
) -> Dict[str, int]:
    """The reference's surgery rule: scale, then floor at depth 6, width
    384, heads 6; the image size becomes 768."""
    out = dict(base)
    out["num_hidden_layers"] = max(6, int(base["num_hidden_layers"] * depth_ratio))
    out["hidden_size"] = max(384, int(base["hidden_size"] * width_ratio))
    out["num_attention_heads"] = max(6, int(base["num_attention_heads"] * head_ratio))
    out["image_size"] = student_image_size
    return out


def owlv2_vision_vit_kwargs(
    pruned: bool = False,
    depth_ratio: float = 0.75,
    width_ratio: float = 0.75,
    head_ratio: float = 0.75,
) -> Dict[str, object]:
    """``ViTConfig`` kwargs for the OWLv2 vision tower: a CLIP-style ViT
    (bias-free patch projection, pre-encoder LayerNorm, quick-GELU MLP, LN
    eps 1e-5). ``pruned=True`` applies the student surgery; the MLP width
    is not scaled, so the MLP ratio widens."""
    geo = (
        prune_owlv2_geometry(OWLV2_BASE_VISION, depth_ratio, width_ratio, head_ratio)
        if pruned
        else dict(OWLV2_BASE_VISION)
    )
    return dict(
        image_size=geo["image_size"],
        patch_size=geo["patch_size"],
        embed_dim=geo["hidden_size"],
        depth=geo["num_hidden_layers"],
        num_heads=geo["num_attention_heads"],
        mlp_ratio=geo["intermediate_size"] / geo["hidden_size"],
        pre_norm=True,
        act="quick_gelu",
        patch_bias=False,
        layer_norm_eps=1e-5,
    )
