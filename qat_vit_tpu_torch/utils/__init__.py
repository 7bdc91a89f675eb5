"""Utilities: checkpoints, and the msgpack codec they are written with."""

from qat_vit_tpu_torch.utils.checkpoint import (
    BestCheckpointer,
    load_checkpoint,
    load_metadata,
    save_checkpoint,
)

__all__ = [
    "BestCheckpointer",
    "load_checkpoint",
    "load_metadata",
    "save_checkpoint",
]
