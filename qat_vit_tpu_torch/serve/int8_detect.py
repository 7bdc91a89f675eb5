"""True-int8 OWLv2 detection serving: int8 tower + float detection heads
(port of ``qat_vit_tpu/serve/int8_detect.py``).

- the vision tower converts as a classifier does (``convert_vit`` in
  feature mode: no head bundle, the final-LN qparams kept) and serves
  through the same int8 machinery; on CUDA the serving preset picks the
  long-sequence chain (K6, ``ops/long_block_kernel.py``) at OWLv2 geometry,
  and the whole token stream leaves it as the dequantized final-LN output;
- the detection heads (``models/owlv2_detect.detection_heads``) run in f32
  on those tokens, as on the fake-quant tower.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from qat_vit_tpu_torch.models.owlv2_detect import detection_heads
from qat_vit_tpu_torch.models.vit import ViTConfig
from qat_vit_tpu_torch.serve.int8_vit import convert_vit, int8_apply, serving_preset

_TOWER = "vision."


def convert_detector(
    params: Dict[str, torch.Tensor],  # the Owlv2Detector's state_dict
    quant_stats: Dict[str, torch.Tensor],  # its observer buffers (vision.…min_val / …max_val)
    cfg: ViTConfig,
    per_channel_weights: bool = False,
) -> Dict[str, Any]:
    """Fold a detector into ``{"tower": <int8 export>, "heads": <float head
    params>}`` (CPU tensors), consumable by :func:`int8_detect_apply`."""
    if cfg.num_classes != 0:
        raise ValueError("detector towers are feature extractors (num_classes=0)")

    def tower(tree):
        return {k[len(_TOWER):]: v for k, v in tree.items() if k.startswith(_TOWER)}

    heads = {k: v.detach().cpu().to(torch.float32) for k, v in params.items()
             if not k.startswith(_TOWER)}
    return {"tower": convert_vit(tower(params), tower(quant_stats), cfg,
                                 per_channel_weights=per_channel_weights),
            "heads": heads}


@torch.no_grad()
def int8_detect_apply(
    export: Dict[str, Any],
    pixels: torch.Tensor,  # [B, H, W, 3] preprocessed images
    cfg: ViTConfig,
    query_embeds: Optional[torch.Tensor] = None,  # [B, Q, text_dim]
    query_mask: Optional[torch.Tensor] = None,  # [B, Q], 1 = valid
    **serve_opts: Any,
) -> Dict[str, torch.Tensor]:
    """Int8 detection forward → the HF-shaped output dict. ``serve_opts``
    are :func:`int8_apply`'s options (fused mode, dtypes, attention)."""
    tokens = int8_apply(export["tower"], pixels, cfg, **serve_opts)
    return detection_heads(export["heads"], tokens, cfg.image_size // cfg.patch_size,
                           query_embeds, query_mask)


def make_int8_detect_forward(cfg: ViTConfig, device, preset: bool = True, **overrides: Any):
    """Serving closure: (export, pixels, query_embeds, query_mask) → the
    detection dict. ``preset=True`` applies :func:`serving_preset` for
    ``device`` (on CUDA at OWLv2 geometry: the megamodel_long chain);
    ``overrides`` win over the preset. The options are ``fwd.options``."""
    opts: Dict[str, Any] = dict(serving_preset(cfg, device)) if preset else {}
    opts.update(overrides)

    def fwd(export, pixels, query_embeds=None, query_mask=None):
        return int8_detect_apply(export, pixels, cfg, query_embeds, query_mask, **opts)

    fwd.options = opts
    return fwd
