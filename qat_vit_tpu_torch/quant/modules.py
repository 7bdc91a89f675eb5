"""``FakeQuantizer``: one fake-quant site as an ``nn.Module`` (port of
``qat_vit_tpu/quant/modules.py``).

The JAX package threads observer state through a ``quant_stats`` variable
collection; here it is two registered buffers, ``min_val`` (``+inf`` at
init) and ``max_val`` (``-inf``), updated in place when ``observe=True``.
``observe=REPLAY`` runs an observing trace again (the recompute of a
rematerialized block, ``ops/remat.py``): the sites fake-quantize from their
stored statistics and update nothing, while the model routes as it does when
it observes.
"""

from __future__ import annotations

import torch
from torch import nn

from qat_vit_tpu_torch.quant.fake_quant import (
    fake_quantize,
    fused_moving_avg_obs_fake_quant,
    observe_and_qparams,
)
from qat_vit_tpu_torch.quant.qconfig import FakeQuantConfig


class _Replay:
    """The ``observe`` value of an observing trace run again: true, so the
    model takes the observing trace's route; the sites write nothing."""

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:
        return "REPLAY"


REPLAY = _Replay()


class FakeQuantizer(nn.Module):
    def __init__(self, cfg: FakeQuantConfig):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("min_val", torch.tensor(float("inf")))
        self.register_buffer("max_val", torch.tensor(float("-inf")))

    def forward(self, x: torch.Tensor, *, observe: bool = False, apply_fq: bool = True):
        if observe is REPLAY:
            return self._replay(x, apply_fq)
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

    def _replay(self, x: torch.Tensor, apply_fq: bool):
        """``observe=REPLAY``: the qparams of the stored statistics, which the
        observing run fake-quantized with, by the ops of that run (no
        identity guard for an unobserved site); nothing is observed or
        stored."""
        cfg = self.cfg
        _, _, scale, zero_point = observe_and_qparams(
            x, self.min_val, self.max_val, symmetric=cfg.symmetric, quant_min=cfg.quant_min,
            quant_max=cfg.quant_max, observe=False)
        if not apply_fq:
            return x, scale, zero_point
        return fake_quantize(x, scale, zero_point, cfg.quant_min, cfg.quant_max)

    def _store(self, observe: bool, new_min: torch.Tensor, new_max: torch.Tensor) -> None:
        if observe:
            with torch.no_grad():
                self.min_val.copy_(new_min)
                self.max_val.copy_(new_max)
