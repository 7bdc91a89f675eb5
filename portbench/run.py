#!/usr/bin/env python3
"""Run one benchmark cell once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic and limits
are the files of those names under ``portbench/``; its metrics are the
readers of their names in ``portbench/metrics/``. The last line of standard
output is the result as one JSON object; the numbers compared against the
plain reference are the last lines of standard error and the result's last
key.
"""

from __future__ import annotations

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.lib import common  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, args, device, t0_wall: float = T0_WALL, plant=None):
    """The driver's run, then the metrics: the end-to-end ones in an
    untraced run, the per-layer ones in a traced one."""
    import torch

    from portbench.drivers.train import arch_of
    from portbench.lib.readers import Context

    drv = common.driver(cell["traffic_file"]["driver"])
    t_start = time.perf_counter() - (time.time() - t0_wall)
    out = drv.run(cell, args.seed, args.seconds, bool(args.trace), device, t_start=t_start,
                  plant=plant)
    cfg = cell["config_file"]
    ctx = Context(run=out, trace=out.get("trace"), arch=arch_of(cfg), traffic=cell["traffic_file"],
                  config=cfg)
    metrics = {}
    for m in (cell["per_layer"] if args.trace else cell["end_to_end"]):
        v = common.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = common.metric(float(v), m["unit"])
    compared = out["compared"]
    result = {
        "correct": bool(common.judge(compared) and out.get("finite", True)),
        "attempted": int(out.get("attempted", out["images"])),
        "failed": int(out.get("attempted", out["images"]) - out["images"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if torch.cuda.is_available() else "cpu",
                   "kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
                   "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])},
    }
    if args.trace and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_us / 1e6
        result["device"]["window_s"] = ctx.trace.span_us / 1e6
        result["breakdown"] = ctx.trace.breakdown()
    common.log(f"window {out['window_s']:.3f} s, {out['images']} images, setup "
               f"{out['setup_s']:.3f} s; {json.dumps({k: v['value'] for k, v in metrics.items()})}")
    result["compared"] = compared
    return result


def emit(result) -> None:
    """The compared numbers on standard error, then the result line
    (``compared`` its last key)."""
    common.print_compared(result["compared"])
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    common.set_run_env()
    # one process, few host threads: the step is host-bound
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    cell = common.cell(args.workload)
    import torch

    world = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        common.log(f"needs {world} CUDA device(s), found {n}")
        return 2
    common.log(f"card: {common.card_line()}")

    from qat_vit_tpu_torch import _build

    lib = _build.load()
    common.log(f"kernel library {lib.path.name}: {lib.build_seconds:.1f} s to build or find; "
               f"{time.time() - T0_WALL:.2f} s since the start")
    result = run_cell(cell, args, torch.device("cuda", 0))
    bad = common.forbidden_loaded()
    if bad:
        common.log(f"JAX or the JAX package loaded: {bad}")
        return 1
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
