"""The harness on the card (``requires_cuda``; each test skips without a
CUDA device):

    python -m pytest --noconftest -m requires_cuda portbench/tests -q
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib import trace, work  # noqa: E402

pytestmark = pytest.mark.requires_cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels and the profiler's device trace")
    return torch.device("cuda")


def test_profiled_gemm_is_busy_and_under_its_roofline(dev):
    a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    for _ in range(3):
        a @ a
    tr = trace.profile(torch, lambda: [a @ a for _ in range(10)], 10)
    assert tr.kernels and 0 < tr.busy_us <= tr.span_us
    ms = sum(e - s for n, s, e in tr.kernels if trace.label(n, trace.GROUPS) == "library GEMM")
    ms = ms / 1e3 / 10
    bound = work.roofline({"ops": 2 * 4096 ** 3, "type": "bf16", "bytes": 3 * 2 * 4096 ** 2})[0]
    assert 0 < 100 * bound / ms <= 100


def test_a_short_run_prints_the_result_line(dev):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "vit_s16_kd.serve_int8",
                          "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "compared" and res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    for name in ("gemm_roofline_pct.serve", "attn_roofline_pct.serve", "mfu_pct.serve"):
        assert 0 < res["metrics"][name]["value"] <= 100
