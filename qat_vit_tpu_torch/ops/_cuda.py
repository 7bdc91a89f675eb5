"""Input checks and launch plumbing shared by the kernel wrappers.

A wrapper takes its plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises, and for any other device it raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# H100: the dynamic shared memory one block may opt into (bytes)
SMEM_LIMIT = 232448


def use_plain(t: torch.Tensor) -> bool:
    """True on the CPU (take the plain version), False on CUDA (launch)."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def require(t: Optional[torch.Tensor], name: str, dtype: torch.dtype,
            device: torch.device, shape: Optional[Sequence[int]] = None,
            align: int = 4) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device`` of
    ``shape`` whose data pointer is ``align``-byte aligned."""
    if t is None:
        raise ValueError(f"{name}: missing")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
