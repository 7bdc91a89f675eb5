"""int8 serving: PTQ calibration, the export, the int8 forward, the predictor,
and int8 detection."""

from qat_vit_tpu_torch.serve.calibrate import calibrate, calibrate_detector, ptq_convert
from qat_vit_tpu_torch.serve.int8_detect import (
    convert_detector,
    int8_detect_apply,
    make_int8_detect_forward,
)
from qat_vit_tpu_torch.serve.int8_vit import convert_vit, int8_apply, make_int8_forward
from qat_vit_tpu_torch.serve.predictor import Int8Predictor

__all__ = [
    "Int8Predictor",
    "calibrate",
    "calibrate_detector",
    "convert_detector",
    "convert_vit",
    "int8_apply",
    "int8_detect_apply",
    "make_int8_detect_forward",
    "make_int8_forward",
    "ptq_convert",
]
