#!/usr/bin/env python3
"""The controls and planted faults behind each cell's limits, from the
plain reference alone, at the cell's own sizes:

    python3 portbench/control.py --workload <name> --seeds 11 12 13

For each seed, on the cell's inputs and weights: the reference put in the
program's place one precision below the configuration's (float8 e4m3
operands for a bf16 training step; 4-bit for int8 serving), and the faults
the cell can have (a training step on half of each batch; a state left
unchanged reads 1 by construction; one served answer replaced by
another's), each compared with the float32 reference as a run compares the
program. One JSON line per seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.lib import common, inputs  # noqa: E402
from portbench.reference import compare, plain_vit  # noqa: E402

ANY = {"logits_rel_l2": 0.0}


def values(readings):
    return {k: v["value"] for k, v in readings.items()}


def train_controls(cell, seed, dev):
    from portbench.drivers import train

    cfg, tf = cell["config_file"], cell["traffic_file"]
    images, labels = inputs.cifar_like(int(tf["train_images"]), seed, 1, dev)
    b = int(tf["batch"])
    order = np.random.default_rng(seed % 2 ** 63).permutation(len(images))
    rows = [order[i * b:(i + 1) * b] for i in range(int(tf["checked_steps"]))]
    from qat_vit_tpu_torch.train.config import load_hparams  # the trainer's defaults

    hp = load_hparams(None)
    hp.update(tf.get("hparams", {}))
    ref = train.reference_readings(cfg, seed, dev, images, labels, rows, hp)

    def vs_ref(r):
        return compare.train_diagnostics(ref["losses"], ref["g1"], ref["delta"], r["losses"],
                                         r["g1"], r["delta"])

    fp8 = train.reference_readings(cfg, seed, dev, images, labels, rows, hp,
                                   num=plain_vit.Numerics(fp8=True))
    half = train.reference_readings(cfg, seed, dev, images, labels, rows, hp, half_batch=True)
    return {"control_fp8": vs_ref(fp8), "fault_half_batch": vs_ref(half)}


def classify_controls(cell, seed, dev):
    from portbench.drivers import serve_classify as sc

    cfg, tf = cell["config_file"], cell["traffic_file"]
    b = int(tf["batch"])
    calib_u8, _ = inputs.cifar_like(int(tf["calib_batches"]) * int(tf["calib_batch"]), seed, 4, dev)
    pool, _ = inputs.cifar_like(int(tf["pool_images"]), seed, 5, dev)
    images = pool[: b * int(tf["check_batches"])]
    ref = sc.reference_logits(cfg, seed, dev, calib_u8, int(tf["calib_batch"]), images)
    int4 = sc.reference_logits(cfg, seed, dev, calib_u8, int(tf["calib_batch"]), images, bits=4)
    altered = ref.clone()
    altered[0] = ref[1]
    return {"control_int4": values(compare.outputs_readings({"logits": int4}, {"logits": ref}, ANY)),
            "fault_answer_altered": values(compare.outputs_readings({"logits": altered},
                                                                    {"logits": ref}, ANY))}


CONTROLS = {"train": train_controls, "serve_classify": classify_controls}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    common.set_run_env()
    cell = common.cell(args.workload)
    fn = CONTROLS[cell["traffic_file"]["driver"]]
    for seed in args.seeds:
        t = time.perf_counter()
        out = fn(cell, seed, torch.device(args.device))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
