"""CIFAR-10 dataset sources (a copy of ``qat_vit_tpu/data/cifar10.py``: the
``.bin`` records are decoded by ``native_loader.decode_cifar_bin``, the C++
decoder where it compiled, else numpy).

The reference uses ``torchvision.datasets.CIFAR10(download=True)`` (reference
src/training/qat_trainer.py:218-219). This environment has no network, so the
loader reads the standard on-disk formats directly (python pickle batches or
the binary ``.bin`` layout — both are what torchvision would have downloaded)
and falls back to a deterministic, *learnable* synthetic set so every test,
smoke run, and benchmark is self-contained.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import Dict, Tuple

import numpy as np

from qat_vit_tpu_torch.data.native_loader import decode_cifar_bin

CIFAR10_MEAN = (0.485, 0.456, 0.406)  # ImageNet norm, as the reference uses
CIFAR10_STD = (0.229, 0.224, 0.225)  # (qat_trainer.py:210-216)
NUM_CLASSES = 10

_PY_DIR = "cifar-10-batches-py"
_BIN_DIR = "cifar-10-batches-bin"
_TGZ = "cifar-10-python.tar.gz"


def _from_pickle_dir(d: str) -> Dict[str, np.ndarray]:
    def load_batch(path):
        with open(path, "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        imgs = entry["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        labels = entry.get("labels", entry.get("fine_labels"))
        return imgs.astype(np.uint8), np.asarray(labels, np.int32)

    train_x, train_y = [], []
    for i in range(1, 6):
        x, y = load_batch(os.path.join(d, f"data_batch_{i}"))
        train_x.append(x)
        train_y.append(y)
    test_x, test_y = load_batch(os.path.join(d, "test_batch"))
    return {
        "train_images": np.concatenate(train_x),
        "train_labels": np.concatenate(train_y),
        "test_images": test_x,
        "test_labels": test_y,
    }


def _from_bin_dir(d: str) -> Dict[str, np.ndarray]:
    def load_bin(path):
        return decode_cifar_bin(np.fromfile(path, np.uint8))  # C++ decoder when available

    train_x, train_y = [], []
    for i in range(1, 6):
        x, y = load_bin(os.path.join(d, f"data_batch_{i}.bin"))
        train_x.append(x)
        train_y.append(y)
    test_x, test_y = load_bin(os.path.join(d, "test_batch.bin"))
    return {
        "train_images": np.concatenate(train_x),
        "train_labels": np.concatenate(train_y),
        "test_images": test_x,
        "test_labels": test_y,
    }


def synthetic_cifar10(
    n_train: int = 50_000, n_test: int = 10_000, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Deterministic class-structured stand-in for CIFAR-10.

    Each class gets a fixed low-frequency color template; samples are the
    template plus noise plus a random shift — enough signal that real training
    code demonstrably learns (used by convergence smoke tests), with the exact
    array shapes/dtypes of the real dataset.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 31.0
    templates = []
    for c in range(NUM_CLASSES):
        f = 1 + c % 5
        phase = c * 0.7
        base = np.stack(
            [
                np.sin(2 * np.pi * f * xx + phase),
                np.cos(2 * np.pi * f * yy + phase),
                np.sin(2 * np.pi * f * (xx + yy) + phase),
            ],
            axis=-1,
        )
        templates.append(base)
    templates = np.stack(templates)  # [10, 32, 32, 3]

    def make(n, rng):
        labels = rng.integers(0, NUM_CLASSES, size=n).astype(np.int32)
        noise = rng.normal(0, 0.35, size=(n, 32, 32, 3)).astype(np.float32)
        imgs = templates[labels] * 0.5 + noise
        imgs = np.clip((imgs * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
        return imgs, labels

    train_x, train_y = make(n_train, np.random.default_rng(seed + 1))
    test_x, test_y = make(n_test, np.random.default_rng(seed + 2))
    return {
        "train_images": train_x,
        "train_labels": train_y,
        "test_images": test_x,
        "test_labels": test_y,
    }


def load_cifar10(
    data_dir: str = "./data", allow_synthetic: bool = True, seed: int = 0
) -> Tuple[Dict[str, np.ndarray], str]:
    """Load CIFAR-10 from ``data_dir``, trying pickle → bin → tar.gz → npz
    cache → synthetic. Returns ``(splits, source_tag)``."""
    pd = os.path.join(data_dir, _PY_DIR)
    if os.path.isdir(pd):
        return _from_pickle_dir(pd), "pickle"
    bd = os.path.join(data_dir, _BIN_DIR)
    if os.path.isdir(bd):
        return _from_bin_dir(bd), "bin"
    tgz = os.path.join(data_dir, _TGZ)
    if os.path.isfile(tgz):
        with tarfile.open(tgz) as tf:
            tf.extractall(data_dir)
        if os.path.isdir(pd):
            return _from_pickle_dir(pd), "pickle"
    npz = os.path.join(data_dir, "cifar10.npz")
    if os.path.isfile(npz):
        with np.load(npz) as z:
            return {k: z[k] for k in z.files}, "npz"
    if allow_synthetic:
        return synthetic_cifar10(seed=seed), "synthetic"
    raise FileNotFoundError(
        f"no CIFAR-10 found under {data_dir!r} (looked for {_PY_DIR}/, "
        f"{_BIN_DIR}/, {_TGZ}, cifar10.npz) and allow_synthetic=False"
    )
