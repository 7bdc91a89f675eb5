"""Model registry and factories (port of the ViT entries of
``qat_vit_tpu/models/registry.py``).

A factory returns a :class:`ModelBundle` whose ``module`` is already built
and initialized (PyTorch modules own their parameters), from a
``torch.Generator`` when one is given. The OWLv2 entries come with the
detection slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

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
    module: VisionTransformer
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


def create_model(name: str, num_classes: int = 10, qat_wrapper: bool = False,
                 **kwargs) -> ModelBundle:
    if name not in _MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[name](num_classes=num_classes, qat_wrapper=qat_wrapper, **kwargs)


def create_student(family: str = "vit", qat_wrapper: bool = True, **kwargs) -> ModelBundle:
    if family == "vit":
        return create_model("vit_small_patch16_224_student", qat_wrapper=qat_wrapper, **kwargs)
    raise ValueError(f"unknown model family: {family!r}")


def list_available_models() -> Dict[str, Dict[str, Any]]:
    return {k: dict(v) for k, v in _MODEL_INFO.items()}
