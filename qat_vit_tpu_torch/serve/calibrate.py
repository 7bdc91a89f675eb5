"""Post-training quantization: calibrate observers on data, then convert
(port of ``qat_vit_tpu/serve/calibrate.py``).

Running the fake-quant model with ``observe=True`` and frozen weights is
torch's PTQ prepare → calibrate → convert flow, with this package's
observers (EMA min/max, c = 0.01, identity until observed).
:func:`calibrate_detector` calibrates a detector's tower, the feature-mode
``VisionTransformer`` under ``vision``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Iterable, Optional

import torch

from qat_vit_tpu_torch.models.vit import VisionTransformer, ViTConfig
from qat_vit_tpu_torch.quant.qconfig import QConfig, default_qat_qconfig
from qat_vit_tpu_torch.serve.int8_vit import convert_vit

logger = logging.getLogger(__name__)


def _observer_buffers(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in module.state_dict().items()
            if k.endswith((".min_val", ".max_val"))}


@torch.no_grad()
def calibrate(
    params: Dict[str, torch.Tensor],  # float model state_dict
    batches: Iterable[torch.Tensor],  # preprocessed [B, H, W, 3] f32 batches
    cfg: ViTConfig,
    qconfig: Optional[QConfig] = None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Observer-only forwards over the calibration batches → the observer
    buffers (``{"…min_val"/"…max_val": 0-d f32}``). Runs on ``device``
    (default: where ``params`` live)."""
    qcfg = qconfig or cfg.quant or default_qat_qconfig()
    qat_cfg = dataclasses.replace(cfg, quant=qcfg, qat_wrapper=True)
    if device is None:
        device = next(iter(params.values())).device
    model = VisionTransformer(qat_cfg).to(device)
    float_params = {k: v for k, v in params.items() if not k.endswith((".min_val", ".max_val"))}
    missing, unexpected = model.load_state_dict(float_params, strict=False)
    missing = [k for k in missing if not k.endswith((".min_val", ".max_val"))]
    if missing or unexpected:
        raise ValueError(f"params do not match {qat_cfg}: missing {missing}, "
                         f"unexpected {unexpected}")
    model.eval()
    n = 0
    for x in batches:
        model(torch.as_tensor(x).to(device), observe=True)
        n += 1
    if n == 0:
        raise ValueError("calibration requires at least one batch")
    logger.info("calibrated observers over %d batches", n)
    return _observer_buffers(model)


def calibrate_detector(
    params: Dict[str, torch.Tensor],  # the Owlv2Detector's state_dict
    batches: Iterable[torch.Tensor],
    cfg: ViTConfig,  # the tower's config (num_classes=0)
    qconfig: Optional[QConfig] = None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """:func:`calibrate` on the detector's tower → its observer buffers,
    named as in the detector (``vision.…min_val`` / ``…max_val``)."""
    tower = {k[len("vision."):]: v for k, v in params.items() if k.startswith("vision.")}
    stats = calibrate(tower, batches, cfg, qconfig, device=device)
    return {f"vision.{k}": v for k, v in stats.items()}


def ptq_convert(
    params: Dict[str, torch.Tensor],
    batches: Iterable[torch.Tensor],
    cfg: ViTConfig,
    qconfig: Optional[QConfig] = None,
    per_channel_weights: bool = False,
    device=None,
) -> Dict[str, Any]:
    """Float params + calibration data → the int8 export (one call)."""
    qcfg = qconfig or cfg.quant or default_qat_qconfig()
    qs = calibrate(params, batches, cfg, qcfg, device=device)
    qat_cfg = dataclasses.replace(cfg, quant=qcfg, qat_wrapper=True)
    return convert_vit(params, qs, qat_cfg, per_channel_weights=per_channel_weights)
