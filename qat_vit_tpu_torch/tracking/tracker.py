"""Experiment tracking: MLflow when installed, an SQLite tracker otherwise
(port of ``qat_vit_tpu/tracking/tracker.py``; standard library only).

The same contract as the JAX package (experiments, named runs, params,
step-stamped metrics, tags, artifacts, run status) in the same SQLite
schema, so each package reads the other's ``mlflow.db``. Metric names
follow the reference (``train_loss``, ``train_loss_ce``, ``train_loss_kd``,
``qat_acc``, ``quant_acc``, ``final_quant_acc``, ...). ``mlflow`` is
imported only by :func:`make_tracker` when it asks for it.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import shutil
import sqlite3
import time
import uuid
from typing import Any, Dict, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS experiments (
    experiment_id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE NOT NULL,
    creation_time INTEGER
);
CREATE TABLE IF NOT EXISTS runs (
    run_uuid TEXT PRIMARY KEY,
    experiment_id INTEGER NOT NULL,
    name TEXT,
    status TEXT DEFAULT 'RUNNING',
    start_time INTEGER,
    end_time INTEGER,
    artifact_uri TEXT
);
CREATE TABLE IF NOT EXISTS params (
    run_uuid TEXT NOT NULL,
    key TEXT NOT NULL,
    value TEXT,
    PRIMARY KEY (run_uuid, key)
);
CREATE TABLE IF NOT EXISTS metrics (
    run_uuid TEXT NOT NULL,
    key TEXT NOT NULL,
    value REAL,
    timestamp INTEGER,
    step INTEGER DEFAULT 0
);
CREATE TABLE IF NOT EXISTS tags (
    run_uuid TEXT NOT NULL,
    key TEXT NOT NULL,
    value TEXT,
    PRIMARY KEY (run_uuid, key)
);
"""


def _uri_to_path(uri: str) -> str:
    if uri.startswith("sqlite:///"):
        return uri[len("sqlite:///") :]
    return uri


class Run:
    """One tracked run (context-manager friendly)."""

    def __init__(self, tracker: "SqliteTracker", run_id: str):
        self._t = tracker
        self.run_id = run_id

    def log_param(self, key: str, value: Any) -> None:
        with self._t._conn() as c:
            c.execute(
                "INSERT OR REPLACE INTO params VALUES (?, ?, ?)",
                (self.run_id, key, str(value)),
            )

    def log_params(self, params: Dict[str, Any]) -> None:
        with self._t._conn() as c:  # one connection, one batch
            c.executemany(
                "INSERT OR REPLACE INTO params VALUES (?, ?, ?)",
                [(self.run_id, k, str(v)) for k, v in params.items()],
            )

    def log_metric(self, key: str, value: float, step: int = 0) -> None:
        with self._t._conn() as c:
            c.execute(
                "INSERT INTO metrics VALUES (?, ?, ?, ?, ?)",
                (self.run_id, key, float(value), int(time.time() * 1000), int(step)),
            )

    def log_metrics(self, metrics: Dict[str, float], step: int = 0) -> None:
        ts = int(time.time() * 1000)
        with self._t._conn() as c:  # one connection, one batch
            c.executemany(
                "INSERT INTO metrics VALUES (?, ?, ?, ?, ?)",
                [(self.run_id, k, float(v), ts, int(step))
                 for k, v in metrics.items()],
            )

    def set_tag(self, key: str, value: Any) -> None:
        with self._t._conn() as c:
            c.execute(
                "INSERT OR REPLACE INTO tags VALUES (?, ?, ?)",
                (self.run_id, key, str(value)),
            )

    def log_artifact(self, path: str) -> None:
        with self._t._conn() as c:
            row = c.execute(
                "SELECT artifact_uri FROM runs WHERE run_uuid=?", (self.run_id,)
            ).fetchone()
        dest = row[0]
        os.makedirs(dest, exist_ok=True)
        shutil.copy2(path, dest)

    def end(self, status: str = "FINISHED") -> None:
        with self._t._conn() as c:
            c.execute(
                "UPDATE runs SET status=?, end_time=? WHERE run_uuid=?",
                (status, int(time.time() * 1000), self.run_id),
            )

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *_):
        self.end("FAILED" if exc_type else "FINISHED")
        return False


class SqliteTracker:
    """Minimal experiment store with mlflow-shaped tables."""

    def __init__(self, uri: str = "sqlite:///mlflow.db", experiment: str = "default",
                 artifact_root: Optional[str] = None, create: bool = True):
        """``create=False`` opens read-only-in-intent: the experiment must
        already exist (a reporting query must not write a misspelled
        experiment into the store)."""
        self.path = _uri_to_path(uri)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self.artifact_root = artifact_root or os.path.join(d, "mlruns_artifacts")
        with self._conn() as c:
            if create:
                c.executescript(_SCHEMA)
                c.execute(
                    "INSERT OR IGNORE INTO experiments (name, creation_time)"
                    " VALUES (?, ?)",
                    (experiment, int(time.time() * 1000)),
                )
            try:
                row = c.execute(
                    "SELECT experiment_id FROM experiments WHERE name=?",
                    (experiment,),
                ).fetchone()
            except sqlite3.OperationalError:  # no schema at all
                row = None
            if row is None:
                names = []
                try:
                    names = [r[0] for r in c.execute(
                        "SELECT name FROM experiments").fetchall()]
                except sqlite3.OperationalError:
                    pass
                raise KeyError(
                    f"experiment {experiment!r} not found in {self.path}"
                    f" (known: {sorted(names)})"
                )
            self.experiment_id = row[0]
        self.experiment = experiment

    @contextlib.contextmanager
    def _conn(self):
        # context manager so every call site CLOSES the connection (a bare
        # `with sqlite3.connect(...)` only commits); a fresh short-lived
        # connection per call keeps the tracker thread-safe (the system
        # metrics sampler logs from its own thread).
        conn = sqlite3.connect(self.path, timeout=30)
        conn.isolation_level = None  # autocommit
        try:
            yield conn
        finally:
            conn.close()

    def start_run(self, name: Optional[str] = None) -> Run:
        run_id = uuid.uuid4().hex
        art = os.path.join(self.artifact_root, run_id)
        with self._conn() as c:
            c.execute(
                "INSERT INTO runs (run_uuid, experiment_id, name, status, start_time,"
                " artifact_uri) VALUES (?, ?, ?, 'RUNNING', ?, ?)",
                (run_id, self.experiment_id, name, int(time.time() * 1000), art),
            )
        return Run(self, run_id)

    # -- read API (used by tests and reporting) --
    def runs(self) -> list:
        with self._conn() as c:
            rows = c.execute(
                "SELECT run_uuid, name, status FROM runs WHERE experiment_id=?",
                (self.experiment_id,),
            ).fetchall()
        return [{"run_id": r[0], "name": r[1], "status": r[2]} for r in rows]

    def metrics(self, run_id: str, key: Optional[str] = None) -> list:
        q = "SELECT key, value, step FROM metrics WHERE run_uuid=?"
        args = [run_id]
        if key:
            q += " AND key=?"
            args.append(key)
        with self._conn() as c:
            return [
                {"key": k, "value": v, "step": s}
                for k, v, s in c.execute(q, args).fetchall()
            ]

    def params(self, run_id: str) -> Dict[str, str]:
        with self._conn() as c:
            return dict(
                c.execute(
                    "SELECT key, value FROM params WHERE run_uuid=?", (run_id,)
                ).fetchall()
            )


class MlflowTracker:  # pragma: no cover - exercised only where mlflow is installed
    """Thin adapter over real mlflow with the same Tracker/Run surface."""

    def __init__(self, uri: str, experiment: str, artifact_root=None):
        _mlflow = importlib.import_module("mlflow")
        _mlflow.set_tracking_uri(uri)
        _mlflow.set_experiment(experiment)
        self.experiment = experiment

    def start_run(self, name: Optional[str] = None):
        _mlflow = importlib.import_module("mlflow")
        active = _mlflow.start_run(run_name=name)

        class _R:
            run_id = active.info.run_id

            def log_param(self, k, v):
                _mlflow.log_param(k, v)

            def log_params(self, p):
                _mlflow.log_params(p)

            def log_metric(self, k, v, step=0):
                _mlflow.log_metric(k, v, step=step)

            def log_metrics(self, m, step=0):
                _mlflow.log_metrics(m, step=step)

            def set_tag(self, k, v):
                _mlflow.set_tag(k, v)

            def log_artifact(self, p):
                _mlflow.log_artifact(p)

            def end(self, status="FINISHED"):
                _mlflow.end_run(status)

            def __enter__(self):
                return self

            def __exit__(self, exc_type, *_):
                self.end("FAILED" if exc_type else "FINISHED")
                return False

        return _R()


def has_mlflow() -> bool:
    """Whether ``mlflow`` imports here (it is imported to find out)."""
    try:
        importlib.import_module("mlflow")
    except Exception:
        return False
    return True


def make_tracker(uri: str, experiment: str, prefer_mlflow: bool = True):
    """Factory: real mlflow when available, the SQLite tracker otherwise."""
    if prefer_mlflow and has_mlflow():
        return MlflowTracker(uri, experiment)
    return SqliteTracker(uri, experiment)


class NullRun:
    """No-op run for non-main processes (rank-0-only logging, reference
    qat_trainer.py:193-201)."""

    run_id = "null"

    def log_param(self, *a, **k): pass
    def log_params(self, *a, **k): pass
    def log_metric(self, *a, **k): pass
    def log_metrics(self, *a, **k): pass
    def set_tag(self, *a, **k): pass
    def log_artifact(self, *a, **k): pass
    def end(self, *a, **k): pass
    def __enter__(self): return self
    def __exit__(self, *a): return False
