"""On-device preprocessing (port of ``preprocess_fn`` in
``qat_vit_tpu/data/pipeline.py``).

uint8 ``[B, h, w, 3]`` → f32 ``[B, size, size, 3]``: /255, bicubic resize as
two small GEMMs, ImageNet normalization. The resize matrix is built in numpy
(float64, then f32) as ``jax.image.resize`` builds it: Keys cubic a = -0.5,
half-pixel centres, each output row renormalized over the in-range taps.
``F.interpolate(mode="bicubic")`` uses a = -0.75 and would not match.
"""

from __future__ import annotations

import numpy as np
import torch

# ImageNet statistics, as qat_vit_tpu/data/cifar10.py (the reference's transform)
CIFAR10_MEAN = (0.485, 0.456, 0.406)
CIFAR10_STD = (0.229, 0.224, 0.225)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                   ((1.5 * x - 2.5) * x) * x + 1.0)
    return np.where(x >= 2.0, 0.0, out)


def resize_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] f32 bicubic interpolation matrix (upsampling, no antialias)."""
    scale = dst / src
    sample = (np.arange(dst, dtype=np.float64) + 0.5) / scale - 0.5
    w = _keys_cubic(sample[None, :] - np.arange(src, dtype=np.float64)[:, None])  # [src, dst]
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= src - 0.5))[None, :], w, 0.0)
    return w.T.astype(np.float32)


def preprocess_fn(size: int = 224, device=None):
    """The preprocessing closure: uint8 NHWC tensor → normalized f32 NHWC on
    the input's device (the matrices and constants are made once per
    device and source size)."""
    cache = {}

    def constants(h: int, w: int, dev: torch.device):
        key = (h, w, str(dev))
        if key not in cache:
            cache[key] = (
                torch.from_numpy(resize_matrix(h, size)).to(dev),
                torch.from_numpy(resize_matrix(w, size)).to(dev),
                torch.tensor(CIFAR10_MEAN, dtype=torch.float32, device=dev),
                torch.tensor(CIFAR10_STD, dtype=torch.float32, device=dev),
            )
        return cache[key]

    def fn(images_u8: torch.Tensor) -> torch.Tensor:
        if device is not None:
            images_u8 = images_u8.to(device, non_blocking=True)
        x = images_u8.to(torch.float32) / 255.0
        _, h, w, _ = x.shape
        wh, ww, mean, std = constants(h, w, x.device)
        if (h, w) != (size, size):
            x = torch.einsum("Hh,bhwc->bHwc", wh, x)
            x = torch.einsum("Ww,bHwc->bHWc", ww, x)
        return (x - mean) / std

    return fn
