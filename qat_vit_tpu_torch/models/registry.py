"""Model registry and factories (port of ``qat_vit_tpu/models/registry.py``).

A factory returns a :class:`ModelBundle` whose ``module`` is already built
and initialized (PyTorch modules own their parameters), from a
``torch.Generator`` when one is given. :func:`create_architecture` builds
one on the ``meta`` device instead: the architecture and its config, no
weights (what a JAX bundle is); :func:`with_weights` draws them. The OWLv2
entries are the vision tower as a classifier (teacher and pruned student)
and the detectors (``task="detection"``: tower + float heads). The two
HuggingFace entries (``*_torch``, ``tpu_compatible=False``, the JAX
package's metadata key) build ``transformers``' ``Owlv2ForObjectDetection``
and raise a ``RuntimeError`` where ``transformers`` is not installed.
:func:`get_model_complexity` counts parameters on the ``meta`` device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from qat_vit_tpu_torch.models.owlv2 import (
    OWLV2_BASE_TEXT,
    OWLV2_BASE_VISION,
    build_owlv2_student_torch,
    owlv2_vision_vit_kwargs,
)
from qat_vit_tpu_torch.models.owlv2_detect import Owlv2Detector, create_detector
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
                   input_size: tuple = (3, 224, 224), tpu_compatible: bool = True,
                   description: str = ""):
    """Register a factory with its metadata; ``tpu_compatible`` keeps the
    JAX package's key: False marks an entry that builds an external
    (``transformers``) module rather than a :class:`ModelBundle`."""

    def deco(fn):
        _MODEL_REGISTRY[name] = fn
        _MODEL_INFO[name] = {"task": task, "input_size": input_size,
                             "tpu_compatible": tpu_compatible, "description": description}
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


def _transformers():
    """``transformers``, imported when an HF entry is built; a
    ``RuntimeError`` naming it where it is not installed."""
    try:
        import transformers
    except ImportError as e:
        raise RuntimeError("owlv2 models require the `transformers` package") from e
    return transformers


@register_model("owlv2_base_teacher_torch", task="detection", input_size=(3, 960, 960),
                tpu_compatible=False,
                description="HF OWLv2 detection teacher (Owlv2ForObjectDetection; needs "
                            "transformers; pretrained weights need network or a local snapshot)")
def _create_owlv2_teacher_torch(pretrained: bool = True, local_path: str = None, **kw):
    """The reference's optional OWLv2 teacher: pretrained from ``local_path``
    (or the hub id, which needs network), or from the published config with
    random init (``pretrained=False``)."""
    tfm = _transformers()
    kw.pop("qat_wrapper", None)
    if pretrained:
        return tfm.Owlv2ForObjectDetection.from_pretrained(
            local_path or "google/owlv2-base-patch16-ensemble")
    config = tfm.Owlv2Config(text_config=dict(OWLV2_BASE_TEXT),
                             vision_config=dict(OWLV2_BASE_VISION))
    return tfm.Owlv2ForObjectDetection(config)


@register_model("owlv2_student_pruned_torch", task="detection", input_size=(3, 768, 768),
                tpu_compatible=False,
                description="HF pruned OWLv2 student by config surgery (needs transformers)")
def _create_owlv2_student_torch(**kw):
    """The pruned HF OWLv2 student (:func:`models.owlv2.build_owlv2_student_torch`)."""
    _transformers()
    kw.pop("qat_wrapper", None)
    kw.pop("num_classes", None)
    return build_owlv2_student_torch(**kw)


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


def create_architecture(name: str, **kwargs) -> ModelBundle:
    """:func:`create_model` on the ``meta`` device: the module's structure
    and config with no weights allocated or drawn (a generator passed is
    left as it was)."""
    with torch.device("meta"):
        return create_model(name, **kwargs)


def with_weights(bundle: ModelBundle, generator: Optional[torch.Generator] = None) -> ModelBundle:
    """``bundle`` with weights: an architecture (built on the ``meta``
    device, :func:`create_architecture`) gets them drawn from ``generator``
    as its factory draws them (a fresh student per seed, as the JAX package
    initializes a bundle); a bundle with weights is returned as it is."""
    if not any(p.is_meta for p in bundle.module.parameters()):
        return bundle
    module = bundle.module
    if isinstance(module, Owlv2Detector):
        built = Owlv2Detector(bundle.cfg, text_dim=module.text_dim, generator=generator)
    else:
        built = VisionTransformer(bundle.cfg, generator=generator)
    return dataclasses.replace(bundle, module=built)


# GFLOPs at 224 px, one forward (the reference's table, ref :450-456: ViT-B
# 17.6 / ViT-S 4.7 / tiny 1.2), as in the JAX package
_GFLOPS = {
    "vit_base_patch16_224_teacher": 17.6,
    "vit_small_patch16_224_student": 4.7,
    "vit_tiny_patch16_224": 1.2,
}


def get_model_complexity(name: str) -> Dict[str, Any]:
    """Parameter count and a GFLOPs estimate (ref :443-457): the parameters
    of the module built on the ``meta`` device (observer buffers are not
    parameters), the table above or, for other entries, 2 flops per MAC over
    the GEMMs, the attention and the patch embedding. The ``*_torch`` entries
    are refused from their metadata, before anything is built."""
    if name not in _MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}")
    if not _MODEL_INFO[name]["tpu_compatible"]:
        raise ValueError(
            f"model {name!r} constructs an external (torch) module; complexity accounting is "
            "defined for ModelBundles only — use the non-_torch registry entry")
    bundle = create_architecture(name)
    cfg = bundle.cfg
    n_params = int(sum(p.numel() for p in bundle.module.parameters()))
    d, l, s, p = cfg.embed_dim, cfg.depth, cfg.seq_len, cfg.num_patches
    gflops = _GFLOPS.get(name)
    if gflops is None:
        gemm = l * (2 * s * d * 3 * d + 2 * s * d * d + 4 * s * d * cfg.mlp_dim)
        attn = l * (2 * s * s * d * 2)
        patch = 2 * p * (cfg.patch_size ** 2 * 3) * d
        gflops = round((gemm + attn + patch) / 1e9, 2)
    return {"name": name, "params": n_params, "gflops": gflops}


def self_test(device="cuda") -> bool:
    """Registry smoke test (ref model_registry.py:463-505): the entries, a
    micro teacher forward, a micro QAT student forward that observes, and
    ViT-S's complexity; on the card unless ``device="cpu"``."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run the self test on the CPU")
    print("available models:")
    for name, info in list_available_models().items():
        print(f"  {name}: {info}")
    gen = torch.Generator().manual_seed(0)
    teacher = create_model("vit_micro_test", generator=gen, device=device)
    student = create_model("vit_micro_test", qat_wrapper=True, generator=gen, device=device)
    x = torch.zeros(2, teacher.cfg.image_size, teacher.cfg.image_size, 3, device=device)
    with torch.no_grad():
        print("teacher fwd:", tuple(teacher.module(x, observe=False).shape))
        print("student QAT fwd:", tuple(student.module(x, observe=True).shape))
    print("complexity:", get_model_complexity("vit_small_patch16_224_student"))
    return True


if __name__ == "__main__":  # pragma: no cover
    self_test()
