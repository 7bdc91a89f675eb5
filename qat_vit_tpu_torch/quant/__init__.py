"""Quantization core: fake-quant ops, observers, qconfig, observer modules."""

from qat_vit_tpu_torch.quant.fake_quant import (
    dequantize,
    fake_quantize,
    fused_moving_avg_obs_fake_quant,
    quantize_to_int,
)
from qat_vit_tpu_torch.quant.modules import FakeQuantizer
from qat_vit_tpu_torch.quant.observers import (
    DEFAULT_AVERAGING_CONSTANT,
    FLOAT32_EPS,
    qparams_affine,
    qparams_fused_affine,
    qparams_fused_symmetric,
    qparams_symmetric,
    qparams_symmetric_per_channel,
    update_moving_avg_minmax,
)
from qat_vit_tpu_torch.quant.qconfig import (
    FakeQuantConfig,
    QConfig,
    default_qat_qconfig,
)

__all__ = [
    "DEFAULT_AVERAGING_CONSTANT",
    "FLOAT32_EPS",
    "FakeQuantConfig",
    "FakeQuantizer",
    "QConfig",
    "default_qat_qconfig",
    "dequantize",
    "fake_quantize",
    "fused_moving_avg_obs_fake_quant",
    "qparams_affine",
    "qparams_fused_affine",
    "qparams_fused_symmetric",
    "qparams_symmetric",
    "qparams_symmetric_per_channel",
    "quantize_to_int",
    "update_moving_avg_minmax",
]
