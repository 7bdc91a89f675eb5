"""Every metric reader on a synthetic profile."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.drivers.train import arch_of  # noqa: E402
from portbench.lib import common, work  # noqa: E402
from portbench.lib.readers import Context  # noqa: E402
from portbench.lib.trace import GROUPS, Trace, label  # noqa: E402

BENCH = json.loads((common.ROOT / "BENCHMARK.json").read_text())


def kernels(names_us, gap_us=10.0):
    """Back-to-back kernels of the given durations with ``gap_us`` between."""
    out, t = [], 0.0
    for name, us in names_us:
        out.append((name, t, t + us))
        t += us + gap_us
    return out


TRAIN_STEP = [("void attention_q_mma_kernel<true, 1>(...)", 4000.0),
              ("void at::native::elementwise_kernel<128, 4>(...)", 2000.0),
              ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", 500.0),
              ("void attention_bwd_rows_mma_kernel<1>(...)", 5000.0),
              ("void attention_bwd_keys_mma_kernel<1>(...)", 5000.0),
              ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)", 100.0),
              ("a_kernel_no_table_knows", 50.0)]
SERVE = [("void int8_wgmma_kernel<0, 2, 4>(...)", 3000.0),
         ("void gemm_resid_ln_kernel<256>(...)", 7500.0),
         ("void attention_q_mma_kernel<false, 2>(...)", 3300.0),
         ("void ln_quantize_regs<...>(...)", 5.0),
         ("a_kernel_no_table_knows", 20.0)]


def ctx_for(cell, names_us, steps=1):
    c = common.cell(cell)
    run = {"images": 2560, "window_s": 2.0, "batches": 10, "host_spans": [0.1, 0.2, 0.3],
           "latencies_s": [0.01 * i for i in range(1, 21)], "setup_s": 30.0}
    tr = Trace(kernels(names_us), [("aten::copy_", 0.0, 1e6)], steps)
    return Context(run=run, trace=tr, arch=arch_of(c["config_file"]), traffic=c["traffic_file"],
                   config=c["config_file"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"]])
def test_each_reader_reads_a_synthetic_profile(metric):
    spec = next(m for m in BENCH["per_layer"] + BENCH["end_to_end"] if m["name"] == metric)
    cell = spec.get("workloads", [w["name"] for w in BENCH["workloads"]])[0]
    names = TRAIN_STEP if "train" in cell else SERVE
    v = common.reader(metric).read(ctx_for(cell, names))
    assert v is not None and v > 0, metric
    if metric.endswith(("roofline_pct.train", "roofline_pct.serve")) or "mfu" in metric:
        assert v < 105


def test_readers_without_a_trace_return_none():
    c = ctx_for("vit_s16_kd.train_qat", TRAIN_STEP)
    c.trace = None
    for m in ("elementwise_ms_per_step.train", "attn_fwd_roofline_pct.train", "idle_pct.train"):
        assert common.reader(m).read(c) is None


def test_roofline_reader_by_hand():
    c = ctx_for("vit_s16_kd.train_qat", TRAIN_STEP)
    fwd, bwd = work.attn_train_works(c.arch, 256)
    got = common.reader("attn_fwd_roofline_pct.train").read(c)
    assert got == pytest.approx(100 * 12 * work.roofline(fwd)[0] / 4.0)
    got = common.reader("attn_bwd_roofline_pct.train").read(c)
    assert got == pytest.approx(100 * 12 * work.roofline(bwd)[0] / 10.0)


def test_unmapped_kernel_goes_to_other():
    c = ctx_for("vit_s16_kd.train_qat", TRAIN_STEP)
    assert label("a_kernel_no_table_knows", GROUPS) == "other"
    elem = common.reader("elementwise_ms_per_step.train").read(c)
    assert elem == pytest.approx((2000.0 + 50.0) / 1e3)  # elementwise + the unknown one
    bd = c.trace.breakdown()
    assert ["other", 50.0 / 1e6] in bd["device_ops"]


def test_idle_share_and_gaps():
    c = ctx_for("vit_s16_kd.serve_int8", SERVE)
    busy = 3000 + 7500 + 3300 + 5 + 20
    span = busy + 4 * 10.0
    assert common.reader("idle_pct.serve").read(c) == pytest.approx(100 * (1 - busy / span))
    gaps = c.trace.breakdown()["idle_gaps"]
    assert len(gaps) == 4 and gaps[0] == ["aten::copy_", pytest.approx(1e-5)]


def test_p95_over_every_batch():
    c = ctx_for("vit_s16_kd.serve_int8", SERVE)
    assert common.reader("serve_p95_ms").read(c) == pytest.approx(1e3 * (0.19 + 0.05 * 0.01))
