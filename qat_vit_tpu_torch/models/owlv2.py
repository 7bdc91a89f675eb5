"""OWLv2 detection family: the vision tower's geometry and the pruned
student's config surgery (port of ``qat_vit_tpu/models/owlv2.py``).

The published ``google/owlv2-base-patch16-ensemble`` geometry and the
reference's surgery rule (depth/width/head ratios, default 0.75, with
floors 6/384/6; student image size 768) are plain functions, copied as
they are. :func:`build_owlv2_student_torch` builds the pruned student as
``transformers``' ``Owlv2ForObjectDetection`` from the published config
(imported when called; a ``RuntimeError`` names it where it is missing).
"""

from __future__ import annotations

from typing import Dict, Optional

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


def build_owlv2_student_torch(
    depth_ratio: float = 0.75,
    width_ratio: float = 0.75,
    head_ratio: float = 0.75,
    checkpoint_path: Optional[str] = None,
):
    """The pruned HF OWLv2 student from the published config and the
    surgery rule (reference :282-327), random init, or the weights of a
    local checkpoint (``torch.load``, the reference's tolerant unwrapping
    through :func:`models.torch_convert.normalize_state_dict_keys`,
    ``strict=False``); a path that is not a file warns and keeps the random
    init."""
    try:
        from transformers import Owlv2Config, Owlv2ForObjectDetection
    except ImportError as e:
        raise RuntimeError("owlv2 models require the `transformers` package") from e

    vision = prune_owlv2_geometry(OWLV2_BASE_VISION, depth_ratio, width_ratio, head_ratio)
    config = Owlv2Config(text_config=dict(OWLV2_BASE_TEXT), vision_config=vision)
    # the top-level mirrors the reference also sets (:292-295)
    config.num_hidden_layers = vision["num_hidden_layers"]
    config.hidden_size = vision["hidden_size"]
    config.num_attention_heads = vision["num_attention_heads"]
    model = Owlv2ForObjectDetection(config)
    if checkpoint_path:
        import os
        import warnings

        if not os.path.isfile(checkpoint_path):
            warnings.warn(f"Checkpoint not found: {checkpoint_path} - using random init",
                          RuntimeWarning)
            return model
        import torch

        from qat_vit_tpu_torch.models.torch_convert import normalize_state_dict_keys

        state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        model.load_state_dict(normalize_state_dict_keys(state), strict=False)
    return model
