"""Model registry and factories (port of ``qat_vit_tpu/models/registry.py``).

A factory returns a :class:`ModelBundle` whose ``module`` is already built
and initialized (PyTorch modules own their parameters), from a
``torch.Generator`` when one is given. The OWLv2 entries are the vision
tower as a classifier (teacher and pruned student) and the detectors
(``task="detection"``: tower + float heads). The two HuggingFace entries
(``*_torch``) need ``transformers`` and wait (ROADMAP.md Queue 2).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from qat_vit_tpu_torch.models.owlv2 import owlv2_vision_vit_kwargs
from qat_vit_tpu_torch.models.owlv2_detect import create_detector
from qat_vit_tpu_torch.models.vit import (
    VIT_BASE,
    VIT_MICRO,
    VIT_SMALL,
    VIT_TINY,
    VisionTransformer,
    ViTConfig,
)
from qat_vit_tpu_torch.quant.qconfig import QConfig, default_qat_qconfig

_MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {}
_MODEL_INFO: Dict[str, Dict[str, Any]] = {}


def register_model(name: str, *, task: str = "classification",
                   input_size: tuple = (3, 224, 224), description: str = ""):
    def deco(fn):
        _MODEL_REGISTRY[name] = fn
        _MODEL_INFO[name] = {"task": task, "input_size": input_size,
                             "description": description}
        return fn

    return deco


@dataclasses.dataclass
class ModelBundle:
    """What a factory returns: the module and its config."""

    name: str
    module: nn.Module  # a VisionTransformer, or an Owlv2Detector for detection
    cfg: ViTConfig
    task: str = "classification"


def _vit_factory(arch: dict, name: str):
    def build(
        num_classes: int = 10,
        qat_wrapper: bool = False,
        quant: Optional[QConfig] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        **kwargs,
    ) -> ModelBundle:
        if qat_wrapper and quant is None:
            quant = default_qat_qconfig("qnnpack")
        cfg = ViTConfig(num_classes=num_classes, quant=quant, qat_wrapper=qat_wrapper,
                        **{**arch, **kwargs})
        # built on the CPU so a seed gives the same weights on every device
        module = VisionTransformer(cfg, generator=generator)
        if device is not None:
            module = module.to(device)
        return ModelBundle(name=name, module=module, cfg=cfg)

    return build


@register_model("vit_base_patch16_224_teacher",
                description="ViT-Base/16 teacher, timm geometry")
def _create_vit_base_teacher(**kw) -> ModelBundle:
    return _vit_factory(VIT_BASE, "vit_base_patch16_224_teacher")(**kw)


@register_model("vit_small_patch16_224_student",
                description="ViT-Small/16 student for KD + int8 QAT, timm geometry")
def _create_vit_small_student(**kw) -> ModelBundle:
    return _vit_factory(VIT_SMALL, "vit_small_patch16_224_student")(**kw)


@register_model("vit_tiny_patch16_224", description="ViT-Tiny/16")
def _create_vit_tiny(**kw) -> ModelBundle:
    return _vit_factory(VIT_TINY, "vit_tiny_patch16_224")(**kw)


@register_model("vit_micro_test", input_size=(3, 32, 32),
                description="2-block micro ViT for tests")
def _create_vit_micro(**kw) -> ModelBundle:
    return _vit_factory(VIT_MICRO, "vit_micro_test")(**kw)


@register_model("owlv2_base_teacher", input_size=(3, 960, 960),
                description="OWLv2-base vision tower (CLIP-style ViT-B/16 at 960 px) "
                            "as a classifier: KD teacher")
def _create_owlv2_teacher(**kw) -> ModelBundle:
    return _vit_factory(owlv2_vision_vit_kwargs(pruned=False), "owlv2_base_teacher")(**kw)


@register_model("owlv2_student_pruned", input_size=(3, 768, 768),
                description="pruned OWLv2 vision tower (depth/width/head ratios, floors "
                            "6/384/6) as a classifier: KD + QAT student")
def _create_owlv2_student(depth_ratio: float = 0.75, width_ratio: float = 0.75,
                          head_ratio: float = 0.75, **kw) -> ModelBundle:
    arch = owlv2_vision_vit_kwargs(pruned=True, depth_ratio=depth_ratio,
                                   width_ratio=width_ratio, head_ratio=head_ratio)
    return _vit_factory(arch, "owlv2_student_pruned")(**kw)


def _detector_factory(pruned: bool, name: str):
    def build(qat_wrapper: bool = False, quant: Optional[QConfig] = None,
              text_dim: int = 512, **kwargs) -> ModelBundle:
        module, cfg = create_detector(pruned=pruned, qat_wrapper=qat_wrapper, quant=quant,
                                      text_dim=text_dim, **kwargs)
        return ModelBundle(name=name, module=module, cfg=cfg, task="detection")

    return build


@register_model("owlv2_base_detector", task="detection", input_size=(3, 960, 960),
                description="OWLv2 open-vocabulary detector: quantizable vision tower + "
                            "float box/class/objectness heads")
def _create_owlv2_detector(**kw) -> ModelBundle:
    return _detector_factory(False, "owlv2_base_detector")(**kw)


@register_model("owlv2_pruned_detector", task="detection", input_size=(3, 768, 768),
                description="pruned OWLv2 detector (surgery geometry); quantizable tower, "
                            "float heads")
def _create_owlv2_pruned_detector(**kw) -> ModelBundle:
    return _detector_factory(True, "owlv2_pruned_detector")(**kw)


def create_model(name: str, num_classes: int = 10, qat_wrapper: bool = False,
                 **kwargs) -> ModelBundle:
    """Registry lookup and construction; ``num_classes`` reaches the
    classification entries only (a detector's tower is a feature extractor)."""
    if name not in _MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_MODEL_REGISTRY)}")
    if _MODEL_INFO[name]["task"] == "classification":
        kwargs["num_classes"] = num_classes
    return _MODEL_REGISTRY[name](qat_wrapper=qat_wrapper, **kwargs)


def create_teacher(family: str = "vit", **kwargs) -> ModelBundle:
    """The frozen ViT-B/16 teacher. The trainer builds it with
    ``dtype=torch.bfloat16`` and no fast_math: bf16 GEMMs, the einsum
    attention with an f32 softmax, erf-GELU, as the JAX package builds it."""
    if family == "vit":
        return create_model("vit_base_patch16_224_teacher", **kwargs)
    if family == "owlv2":
        return create_model("owlv2_base_teacher", **kwargs)
    raise ValueError(f"unknown model family: {family!r}")


def create_student(family: str = "vit", qat_wrapper: bool = True, **kwargs) -> ModelBundle:
    if family == "vit":
        return create_model("vit_small_patch16_224_student", qat_wrapper=qat_wrapper, **kwargs)
    if family == "owlv2":
        return create_model("owlv2_student_pruned", qat_wrapper=qat_wrapper, **kwargs)
    raise ValueError(f"unknown model family: {family!r}")


def list_available_models() -> Dict[str, Dict[str, Any]]:
    return {k: dict(v) for k, v in _MODEL_INFO.items()}
