"""The control comes out not correct: the plain reference put in the
program's place one precision below the configuration's (float8 operands
in the bf16 train step, 4-bit serving), at a micro size on the CPU, judged
by the cell's own limits. At the cells' sizes ``portbench/control.py``
reads the same on the card (``PERF.md`` gives its readings)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import control  # noqa: E402
from portbench.tests.micro import micro_cell  # noqa: E402

COMPARED = {"train": {"grad_p90": "grad_norm_gap_p90_leaf", "grad_diff_p90": "grad_diff_p90_leaf",
                      "update_worst": "update_norm_gap_worst_leaf"}}


@pytest.mark.parametrize("cell", ["vit_s16_kd.train_qat", "vit_s16_kd.serve_int8"])
def test_control_is_not_correct(cell):
    torch.set_num_threads(2)
    c = micro_cell(cell)
    driver = c["traffic_file"]["driver"]
    out = control.CONTROLS[driver](c, 3_000_000_041, torch.device("cpu"))
    readings = out["control_fp8"] if driver == "train" else out["control_int4"]
    names = COMPARED.get(driver, {k: k for k in c["limits"]})
    over = {names[k]: v for k, v in readings.items() if k in names and v > c["limits"][names[k]]}
    assert over, readings
