"""What the metric readers share. A reader is ``read(ctx) -> float | None``
in ``portbench/metrics/<metric>.py``; ``ctx`` holds the run's window
(``ctx.run``: the driver's record), its profiled tail (``ctx.trace``, a
``lib.trace.Trace``, or None), the model's geometry (``ctx.arch``), the
cell's traffic parameters (``ctx.traffic``) and configuration
(``ctx.config``). A reader that finds
nothing to read returns None, and the metric is left out of the line."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Optional

from portbench.lib import work
from portbench.lib.trace import Table, Trace


@dataclasses.dataclass
class Context:
    run: Dict[str, Any]
    trace: Optional[Trace]
    arch: Any
    traffic: Dict[str, Any]
    config: Dict[str, Any]


def device_ms_per_step(ctx: Context, table: Table, labels) -> Optional[float]:
    """Device ms per profiled step of the kernels the table gives one of
    ``labels`` (None without a trace)."""
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    us = sum(v for k, v in ctx.trace.by_label(table).items() if k in labels)
    return us / 1e3 / ctx.trace.steps


def roofline_pct(ctx: Context, table: Table, lab: str, works: List[dict]) -> Optional[float]:
    """100 x (the works' least time, each at its own bound) / (device time
    of the kernels the table labels ``lab``), per profiled step; None where
    no kernel of the table ran."""
    ms = device_ms_per_step(ctx, table, (lab,))
    if not ms:
        return None
    bound = sum(work.roofline(w)[0] for w in works)
    return 100.0 * bound / ms


def idle_pct(ctx: Context) -> Optional[float]:
    if ctx.trace is None or not ctx.trace.span_us:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.span_us)


def median_ms(values: List[float]) -> Optional[float]:
    return 1e3 * statistics.median(values) if values else None

