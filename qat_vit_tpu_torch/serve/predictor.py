"""Batched int8 serving on one device: raw uint8 images in, logits/labels
out (port of ``qat_vit_tpu/serve/predictor.py``).

Preprocessing (bicubic resize + normalize) runs on the device, so the host
→ device copy carries uint8 pixels only. Batches are padded to
``batch_size`` so every call sees one shape. :meth:`Int8Predictor.from_checkpoint`
serves an int8 export from its msgpack file (either package's).
"""

from __future__ import annotations

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
    """Predictor over an int8 export on one device.

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
    # data-parallel serving over several devices comes with the DDP slice
    mesh: Optional[Any] = None
    # the card unless the caller asks for the CPU; no fallback
    device: Any = "cuda"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "multi-device serving (mesh) is not ported yet: ROADMAP.md Queue 1, item 5"
            )
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
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
        self.qparams = export_to_device(self.qparams, self.device)
        self._prep = preprocess_fn(self.cfg.image_size, device=self.device)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: ViTConfig, device: Any = "cuda",
                        **kw) -> "Int8Predictor":
        """The predictor over the int8 export saved at ``path``: integer
        leaves keep their dtype (``w_int8`` int8, ``w_colsum`` int32), floats
        become f32, and the 0-d qparams stay on the host (``export_to_device``)."""
        return cls(qparams=export_from_numpy(load_checkpoint(path)), cfg=cfg, device=device,
                   **kw)

    def _forward(self, images_u8: np.ndarray) -> torch.Tensor:
        batch = torch.from_numpy(np.ascontiguousarray(images_u8))
        if self.device.type == "cuda":
            batch = batch.pin_memory()
        return self._fwd(self.qparams, self._prep(batch))

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
