"""What every cell shares: finding a cell's files by name, the run's
environment, the card's description, statistics and the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parents[1]  # portbench/
ROOT = BENCH.parent  # the checkout
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "qat_vit_tpu")


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return read_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> Dict[str, Any]:
    """The cell ``name`` with its configuration, traffic and limits, each
    read from the file of that name."""
    bench = benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"unknown workload {name!r}")
    w = dict(found[0])
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    w["config_file"] = read_json(ROOT / cfg_entry["file"])
    w["traffic_file"] = read_json(BENCH / "traffic" / f"{w['traffic']}.json")
    w["limits"] = read_json(BENCH / "limits" / f"{name}.json")
    w["end_to_end"] = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    w["per_layer"] = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return w


def load_module(path: Path):
    """A module from its file (names may hold dots: metric readers)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return load_module(BENCH / "drivers" / f"{name}.py")


def reader(metric: str):
    return load_module(BENCH / "metrics" / f"{metric}.py")


def set_run_env() -> None:
    """Caches at fixed paths inside the checkout, and no JAX pulled in by a
    library the port uses."""
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("TRANSFORMERS_NO_ADVISORY_WARNINGS", "1")


def forbidden_loaded() -> List[str]:
    """Modules of JAX or of the JAX package in this process, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def percentile(values: List[float], p: float) -> float:
    """The ``p``-th percentile, linear between closest ranks."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    k = (len(xs) - 1) * p / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def phase(name: str, t_start: float) -> None:
    """A set-up or check phase's end, in seconds since the process started
    (``t_start`` on the ``perf_counter`` clock), on standard error."""
    import time

    log(f"{name}: {time.perf_counter() - t_start:.2f} s")


def metric(value: float, unit: str) -> Dict[str, Any]:
    return {"value": value, "unit": unit}


def judge(compared: Dict[str, Dict[str, float]]) -> bool:
    """Every compared number at or under its limit (a NaN fails)."""
    return all(c["value"] <= c["limit"] for c in compared.values())


def print_compared(compared: Dict[str, Dict[str, float]]) -> None:
    for k, c in compared.items():
        print(f"compared {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)


def seeded(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's seed and a salt."""
    return (int(seed) * 1_000_003 + salt) % (2 ** 63 - 1)


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]

