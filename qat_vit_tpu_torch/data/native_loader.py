"""ctypes bridge to the native (C++) host data plane, with a numpy fallback
(a copy of ``qat_vit_tpu/data/native_loader.py``).

``_native/cifar_native.cpp`` is compiled with ``g++`` at first use into
``qat_vit_tpu_torch/_build/native/`` (ignored by git; ``QVT_NATIVE_DIR``
moves it) and loaded with ctypes. Every entry point has a numpy fallback
that gives the same arrays, so the package works where no compiler exists:
the native path is a host-side speed-up of the input pipeline (the CIFAR
``.bin`` decode and the batch gather), no device code. Each of those two
counts the calls that took the native path in ``<function>.native_calls``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "data", "_native", "cifar_native.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_dir() -> str:
    d = os.environ.get("QVT_NATIVE_DIR", os.path.join(_PKG, "_build", "native"))
    os.makedirs(d, exist_ok=True)
    return d


def load_native() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the native library; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so_path = os.path.join(_build_dir(), "libcifar_native.so")
        try:
            if not os.path.isfile(so_path) or (
                    os.path.getmtime(so_path) < os.path.getmtime(_SRC)):
                tmp = f"{so_path}.{os.getpid()}.tmp"
                cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(so_path)
            lib.decode_cifar_bin.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            lib.gather_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
            lib.gather_labels.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            lib.shuffle_indices.argtypes = [ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p]
            lib.native_abi_version.restype = ctypes.c_int32
            assert lib.native_abi_version() == 1
            _LIB = lib
            logger.info("native data plane loaded (%s)", so_path)
        except Exception as e:
            logger.info("native data plane unavailable (%s); using numpy", e)
            _LIB = None
        return _LIB


def native_available() -> bool:
    return load_native() is not None


def decode_cifar_bin(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR ``.bin`` records (label byte + 3x32x32 CHW pixels) → (NHWC uint8
    images, int32 labels)."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    n = raw.size // 3073
    lib = load_native()
    if lib is not None:
        images = np.empty((n, 32, 32, 3), np.uint8)
        labels = np.empty((n,), np.int32)
        lib.decode_cifar_bin(raw.ctypes.data, n, images.ctypes.data, labels.ctypes.data)
        decode_cifar_bin.native_calls += 1
        return images, labels
    rec = raw.reshape(n, 3073)
    labels = rec[:, 0].astype(np.int32)
    images = rec[:, 1:].reshape(n, 3, 32, 32).transpose(0, 2, 3, 1).copy()
    return images, labels


def gather_batch(images: np.ndarray, labels: np.ndarray,
                 indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Collate one batch by index (a native memcpy loop when available)."""
    lib = load_native()
    if lib is not None and images.flags.c_contiguous:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        n = len(idx)
        img_bytes = int(np.prod(images.shape[1:])) * images.itemsize
        out_img = np.empty((n,) + images.shape[1:], images.dtype)
        lib.gather_batch(images.ctypes.data, idx.ctypes.data, n, img_bytes, out_img.ctypes.data)
        lab = np.ascontiguousarray(labels, dtype=np.int32)
        out_lab = np.empty((n,), np.int32)
        lib.gather_labels(lab.ctypes.data, idx.ctypes.data, n, out_lab.ctypes.data)
        gather_batch.native_calls += 1
        return out_img, out_lab
    return images[indices], labels[indices].astype(np.int32)


decode_cifar_bin.native_calls = 0
gather_batch.native_calls = 0


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """Native Fisher-Yates permutation (the numpy fallback uses default_rng:
    another permutation). A standalone utility: the pipeline shuffles with
    numpy's ``default_rng`` so that its order never depends on whether the
    library compiled."""
    lib = load_native()
    if lib is not None:
        out = np.empty((n,), np.int64)
        lib.shuffle_indices(n, np.uint64(seed), out.ctypes.data)
        return out
    return np.random.default_rng(seed).permutation(n).astype(np.int64)
