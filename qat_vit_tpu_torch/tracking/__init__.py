"""Tracking: an MLflow-compatible experiment store (SQLite built in, the JAX
package's schema), system metrics and the report."""

from qat_vit_tpu_torch.tracking.system_metrics import (
    SystemMetricsLogger,
    enable_system_metrics_logging,
)
from qat_vit_tpu_torch.tracking.tracker import (
    MlflowTracker,
    NullRun,
    Run,
    SqliteTracker,
    has_mlflow,
    make_tracker,
)

__all__ = [
    "MlflowTracker",
    "NullRun",
    "Run",
    "SqliteTracker",
    "SystemMetricsLogger",
    "enable_system_metrics_logging",
    "has_mlflow",
    "make_tracker",
]
