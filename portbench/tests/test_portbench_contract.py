"""``BENCHMARK.json`` and the files the harness finds by name."""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib import common  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_found_by_name(cell):
    c = common.cell(cell)
    assert c["config_file"]["name"] == c["config"]
    assert (common.BENCH / "drivers" / f"{c['traffic_file']['driver']}.py").is_file()
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(common.reader(m["name"]).read), m["name"]
    assert c["limits"] and all(v > 0 for v in c["limits"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_layers_move(cell):
    c = common.cell(cell)
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e, (cell, m["name"])


def test_per_layer_names_their_layer_and_cells():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(cfg):
    f = json.loads((ROOT / cfg["file"]).read_text())
    assert f["source"] == cfg["source"] and f["reduced"] == cfg["reduced"]
    for k in cfg["reduced"]:  # no width is ever cut
        assert not re.search(r"hidden_size|intermediate|_dim$|_rank$|head_dim", k)


def test_run_budget_fits():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
