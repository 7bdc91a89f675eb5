"""Profiling: a ``torch.profiler`` trace of a block, and a step timer (port
of ``qat_vit_tpu/utils/profiling.py``).

:func:`trace` records host activity always and device activity on a CUDA
device, and writes a Chrome trace (``*.pt.trace.json``, for Perfetto or
``chrome://tracing``) into ``log_dir``: every kernel the block launched is
in it by name.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block into ``log_dir``; ``device``: where the
    block runs (CUDA activity is recorded when it is a CUDA device, or, with
    no device given, whenever CUDA is available)."""
    os.makedirs(log_dir, exist_ok=True)
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    with prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


class StepTimer:
    """Wall-clock step timer with warmup discard and summary stats."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._n = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def p50(self) -> float:
        if not self.times:
            return float("nan")
        s = sorted(self.times)
        return s[len(s) // 2]

    def imgs_per_sec(self, batch_size: int) -> float:
        return batch_size / self.mean if self.times else 0.0
