"""Input pipeline (port of ``qat_vit_tpu/data/pipeline.py``): the
DistributedSampler-parity index shards (:func:`epoch_indices`), a
single-process loader over in-memory arrays (:class:`ArrayLoader`), and
on-device preprocessing (:func:`preprocess_fn`).

Preprocessing:
uint8 ``[B, h, w, 3]`` → f32 ``[B, size, size, 3]``: /255, bicubic resize as
two small GEMMs, ImageNet normalization. The resize matrix is built in numpy
(float64, then f32) as ``jax.image.resize`` builds it: Keys cubic a = -0.5,
half-pixel centres, each output row renormalized over the in-range taps.
``F.interpolate(mode="bicubic")`` uses a = -0.75 and would not match.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from qat_vit_tpu_torch.data.cifar10 import CIFAR10_MEAN, CIFAR10_STD


def epoch_indices(
    n: int,
    *,
    epoch: int,
    seed: int = 0,
    shuffle: bool = True,
    rank: int = 0,
    world_size: int = 1,
    drop_last: bool = False,
) -> np.ndarray:
    """Per-epoch, per-rank index shard with torch DistributedSampler
    semantics: epoch-seeded numpy permutation (the JAX package's, so both
    packages visit the same images in the same order), pad by wraparound to
    a common length, rank-strided slice."""
    if shuffle:
        indices = np.random.default_rng(seed + epoch).permutation(n)
    else:
        indices = np.arange(n)
    if drop_last:
        total = (n // world_size) * world_size
        indices = indices[:total]
    else:
        total = -(-n // world_size) * world_size
        if total > n:
            indices = np.concatenate([indices, indices[: total - n]])
    return indices[rank:total:world_size]


@dataclasses.dataclass
class ArrayLoader:
    """Batches over in-memory arrays, in this process and on one rank: each
    batch is one numpy fancy-index (microseconds), so no worker processes or
    prefetch thread are needed. Yields ``{"image", "label", "index"}`` numpy
    arrays."""

    images: np.ndarray  # [N, 32, 32, 3] uint8
    labels: np.ndarray  # [N] int32
    batch_size: int
    shuffle: bool = True
    seed: int = 0
    drop_last: bool = True

    def __post_init__(self):
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """The sampler's reshuffle hook."""
        self._epoch = epoch

    def _indices(self, epoch: int, shuffle: bool) -> np.ndarray:
        return epoch_indices(len(self.images), epoch=epoch, seed=self.seed, shuffle=shuffle,
                             drop_last=self.drop_last)

    def __len__(self) -> int:
        per_rank = len(self._indices(0, False))
        if self.drop_last:
            return per_rank // self.batch_size
        return -(-per_rank // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices(self._epoch, self.shuffle)
        for b in range(len(self)):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield {"image": self.images[sel],
                   "label": np.asarray(self.labels[sel], np.int32),
                   "index": np.asarray(sel, np.int64)}


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
