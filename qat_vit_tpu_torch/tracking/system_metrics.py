"""Background system-metrics sampling into the tracker (port of
``qat_vit_tpu/tracking/system_metrics.py``).

Parity for the reference's ``mlflow.enable_system_metrics_logging()``: a
daemon thread samples host CPU and memory (from /proc; psutil is not a
dependency) and, on a CUDA device, the memory torch has allocated there
(``torch.cuda.memory_allocated``) every ``interval`` seconds and logs them as
``system/...`` metrics. On the CPU there is no device metric.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import torch

logger = logging.getLogger(__name__)


def _read_proc_stat():
    with open("/proc/stat") as f:
        parts = f.readline().split()[1:8]
    vals = list(map(int, parts))
    idle = vals[3] + vals[4]
    return sum(vals), idle


def _read_meminfo():
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            info[k] = int(v.strip().split()[0])  # kB
    total = info.get("MemTotal", 1)
    avail = info.get("MemAvailable", 0)
    return (total - avail) / 1024.0, total / 1024.0  # MB used, MB total


def _device_memory_mb(device) -> Optional[float]:
    """MB that torch has allocated on ``device`` (a CUDA device), else None."""
    if device is None or torch.device(device).type != "cuda":
        return None
    return torch.cuda.memory_allocated(torch.device(device)) / 1e6


class SystemMetricsLogger:
    """Start/stop-able sampler mirroring mlflow's system metrics thread."""

    def __init__(self, run, interval: float = 10.0, device=None):
        self.run = run
        self.interval = interval
        self.device = device
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SystemMetricsLogger":
        if self._thread is not None:
            return self
        self._stop.clear()  # restartable: a prior stop() left the event set
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        step = 0
        prev_total, prev_idle = _read_proc_stat()
        while not self._stop.wait(self.interval):
            try:
                total, idle = _read_proc_stat()
                dt_total = total - prev_total
                dt_idle = idle - prev_idle
                prev_total, prev_idle = total, idle
                cpu = 100.0 * (1.0 - dt_idle / dt_total) if dt_total else 0.0
                mem_used, _ = _read_meminfo()
                metrics = {
                    "system/cpu_utilization_percentage": cpu,
                    "system/system_memory_usage_megabytes": mem_used,
                }
                dev = _device_memory_mb(self.device)
                if dev is not None:
                    metrics["system/device_memory_usage_megabytes"] = dev
                self.run.log_metrics(metrics, step=step)
                step += 1
            except Exception as e:  # never take down training
                logger.debug("system metrics sample failed: %s", e)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def enable_system_metrics_logging(run, interval: float = 10.0,
                                  device=None) -> SystemMetricsLogger:
    """mlflow-API-shaped convenience (ref qat_trainer.py:201); ``device``:
    the trainer's device, sampled when it is a CUDA device."""
    return SystemMetricsLogger(run, interval, device).start()
