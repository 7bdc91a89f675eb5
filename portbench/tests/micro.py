"""Micro-sized cells for the CPU tests: each cell's configuration and
traffic shrunk so that a whole run takes seconds on the CPU (the program's
plain paths), its limits the cell's own."""

from __future__ import annotations

import argparse
import time

import torch

from portbench import run as harness
from portbench.lib import common

MICRO_VIT = dict(registry="vit_micro_test", hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=512, image_size=32, patch_size=8,
                 num_labels=10)


def micro_cell(name):
    cell = common.cell(name)
    cfg, tf = cell["config_file"], cell["traffic_file"]
    if tf["driver"] == "train":
        cfg.update(MICRO_VIT)
        cfg["teacher"].update(MICRO_VIT)
        tf.update(batch=8, train_images=64, teacher_batch=32)
    else:
        cfg.update(MICRO_VIT)
        tf.update(batch=8, pool_images=64, calib_batches=2, calib_batch=4, warmup_batches=2,
                  check_batches=2)
    return cell


def run_micro(name, plant=None, seed=3_000_000_019):
    """One run of the micro cell on the CPU: the result line as a dict."""
    torch.set_num_threads(2)
    args = argparse.Namespace(seed=seed, seconds=0.3, trace=0)
    return harness.run_cell(micro_cell(name), args, "cpu", t0_wall=time.time(), plant=plant)


