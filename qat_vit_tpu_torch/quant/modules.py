"""``FakeQuantizer``: one fake-quant site as an ``nn.Module`` (port of
``qat_vit_tpu/quant/modules.py``).

The JAX package threads observer state through a ``quant_stats`` variable
collection; here it is two registered buffers, ``min_val`` (``+inf`` at
init) and ``max_val`` (``-inf``), updated in place when ``observe=True``.
"""

from __future__ import annotations

import torch
from torch import nn

from qat_vit_tpu_torch.quant.fake_quant import fused_moving_avg_obs_fake_quant, observe_and_qparams
from qat_vit_tpu_torch.quant.qconfig import FakeQuantConfig


class FakeQuantizer(nn.Module):
    def __init__(self, cfg: FakeQuantConfig):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("min_val", torch.tensor(float("inf")))
        self.register_buffer("max_val", torch.tensor(float("-inf")))

    def forward(self, x: torch.Tensor, *, observe: bool = False, apply_fq: bool = True):
        if not apply_fq:
            new_min, new_max, scale, zero_point = observe_and_qparams(
                x,
                self.min_val,
                self.max_val,
                symmetric=self.cfg.symmetric,
                quant_min=self.cfg.quant_min,
                quant_max=self.cfg.quant_max,
                observe=observe,
                averaging_constant=self.cfg.averaging_constant,
                stride=self.cfg.observe_stride,
                axis_name=self.cfg.axis_name,
            )
            self._store(observe, new_min, new_max)
            return x, scale, zero_point
        y, new_min, new_max = fused_moving_avg_obs_fake_quant(
            x,
            self.min_val,
            self.max_val,
            symmetric=self.cfg.symmetric,
            quant_min=self.cfg.quant_min,
            quant_max=self.cfg.quant_max,
            observe=observe,
            averaging_constant=self.cfg.averaging_constant,
            stride=self.cfg.observe_stride,
            axis_name=self.cfg.axis_name,
        )
        self._store(observe, new_min, new_max)
        return y

    def _store(self, observe: bool, new_min: torch.Tensor, new_max: torch.Tensor) -> None:
        if observe:
            with torch.no_grad():
                self.min_val.copy_(new_min)
                self.max_val.copy_(new_max)
