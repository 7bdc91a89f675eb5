"""ViT model, registry and the JAX-tree bridge."""

from qat_vit_tpu_torch.models.registry import (
    ModelBundle,
    create_model,
    create_student,
    list_available_models,
)
from qat_vit_tpu_torch.models.vit import (
    VisionTransformer,
    ViTConfig,
    count_fake_quant_sites,
)

__all__ = [
    "ModelBundle",
    "VisionTransformer",
    "ViTConfig",
    "count_fake_quant_sites",
    "create_model",
    "create_student",
    "list_available_models",
]
