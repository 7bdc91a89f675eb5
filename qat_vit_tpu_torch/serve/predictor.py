"""Batched int8 serving on one device, or data-parallel over several in
one process: raw uint8 images in, logits/labels out (port of
``qat_vit_tpu/serve/predictor.py``).

Preprocessing (bicubic resize + normalize) runs on the device, so the host
→ device copy carries uint8 pixels only. Batches are padded to
``batch_size`` so every call sees one shape. With ``mesh=`` (``parallel.
make_mesh``) each device holds a replica of the export; a batch is split
into equal contiguous shards, one per device, with no collective in the
forward, and the logits are concatenated in order (JAX's ``shard_map``
over the mesh). :meth:`Int8Predictor.from_checkpoint` serves an int8 export
from its msgpack file (either package's).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from qat_vit_tpu_torch.data.pipeline import preprocess_fn
from qat_vit_tpu_torch.models.jax_params import export_from_numpy
from qat_vit_tpu_torch.models.vit import ViTConfig
from qat_vit_tpu_torch.serve.int8_vit import export_to_device, make_int8_forward, serving_preset
from qat_vit_tpu_torch.utils.checkpoint import load_checkpoint


@dataclasses.dataclass
class Int8Predictor:
    """Predictor over an int8 export on one device (or a mesh of them).

    >>> pred = Int8Predictor(export, cfg, device="cuda")
    >>> pred = Int8Predictor.from_checkpoint("best_converted.msgpack", cfg)
    >>> labels = pred.predict(images_u8)          # any N, auto-batched
    """

    qparams: Dict[str, Any]
    cfg: ViTConfig
    batch_size: int = 256
    # None = auto (the preset's choice on CUDA, bf16 otherwise); an explicit
    # dtype always wins over the preset
    compute_dtype: Any = None
    attn_dtype: Any = None
    preset: bool = True
    # explicit serving options (int8_apply's); each one given wins over the preset
    use_pallas: Optional[bool] = None
    fused: Optional[Union[str, bool]] = None
    attn_impl: Optional[str] = None
    # data-parallel serving (``parallel.make_mesh``): a replica of the export
    # on each of the mesh's devices, which then replace ``device``;
    # ``batch_size`` must divide by their count
    mesh: Optional[Any] = None
    # the card unless the caller asks for the CPU; no fallback
    device: Any = "cuda"

    def __post_init__(self):
        devices = list(self.mesh.devices) if self.mesh is not None else [self.device]
        if self.batch_size % len(devices):
            raise ValueError(f"batch_size {self.batch_size} not divisible by the "
                             f"{len(devices)}-device serving mesh")
        self.device = torch.device(devices[0])
        if any(torch.device(d).type == "cuda" for d in devices) and not torch.cuda.is_available():
            raise RuntimeError("Int8Predictor: no CUDA device; pass device='cpu' to serve on "
                               "the CPU")
        opts: Dict[str, Any] = {"attn_dtype": torch.bfloat16, "compute_dtype": torch.bfloat16}
        if self.preset:
            opts.update(serving_preset(self.cfg, self.device))
        if self.attn_dtype is not None:
            opts["attn_dtype"] = self.attn_dtype
        if self.compute_dtype is not None:
            opts["compute_dtype"] = self.compute_dtype
        for key in ("use_pallas", "fused", "attn_impl"):
            if getattr(self, key) is not None:
                opts[key] = getattr(self, key)
        self.options = opts
        self._fwd = make_int8_forward(self.cfg, **opts)
        self._replicas = [(torch.device(d), export_to_device(self.qparams, d),
                           preprocess_fn(self.cfg.image_size, device=d)) for d in devices]
        self.qparams = self._replicas[0][1]

    @classmethod
    def from_checkpoint(cls, path: str, cfg: ViTConfig, device: Any = "cuda",
                        **kw) -> "Int8Predictor":
        """The predictor over the int8 export saved at ``path``: integer
        leaves keep their dtype (``w_int8`` int8, ``w_colsum`` int32), floats
        become f32, and the 0-d qparams stay on the host (``export_to_device``)."""
        return cls(qparams=export_from_numpy(load_checkpoint(path)), cfg=cfg, device=device,
                   **kw)

    def _forward(self, images_u8: np.ndarray) -> torch.Tensor:
        """Logits of one padded batch on ``device``: each replica takes its
        contiguous shard (every launch queued before any result is read)."""
        batch = torch.from_numpy(np.ascontiguousarray(images_u8))
        if self.device.type == "cuda":
            batch = batch.pin_memory()
        if len(self._replicas) == 1:
            _, qparams, prep = self._replicas[0]
            return self._fwd(qparams, prep(batch))
        outs = []
        for (dev, qparams, prep), shard in zip(self._replicas, batch.chunk(len(self._replicas))):
            on_card = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
            with on_card:
                outs.append(self._fwd(qparams, prep(shard)))
        return torch.cat([o.to(self.device) for o in outs])

    def _padded(self, chunk: np.ndarray):
        pad = self.batch_size - len(chunk)
        if pad > 0:
            chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        return chunk, max(pad, 0)

    def logits(self, images_u8: np.ndarray) -> np.ndarray:
        """[N, H0, W0, 3] uint8 → [N, classes] f32."""
        outs = []
        for start in range(0, len(images_u8), self.batch_size):
            chunk, pad = self._padded(images_u8[start : start + self.batch_size])
            out = self._forward(chunk)
            outs.append(out.cpu().numpy()[: self.batch_size - pad])
        return np.concatenate(outs) if outs else np.zeros((0, self.cfg.num_classes), np.float32)

    def predict(self, images_u8: np.ndarray) -> np.ndarray:
        """Top-1 labels."""
        return self.logits(images_u8).argmax(-1).astype(np.int32)

    def serve_stream(self, batches: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        """Pipelined streaming inference: batch k+1 is queued on the device
        before batch k's logits are read back."""
        pending, pending_n = None, 0
        for batch in batches:
            n = len(batch)
            if n > self.batch_size:
                if pending is not None:
                    yield pending.cpu().numpy()[:pending_n]
                    pending = None
                yield self.logits(batch)
                continue
            chunk, _ = self._padded(batch)
            out = self._forward(chunk)
            if pending is not None:
                yield pending.cpu().numpy()[:pending_n]
            pending, pending_n = out, n
        if pending is not None:
            yield pending.cpu().numpy()[:pending_n]
