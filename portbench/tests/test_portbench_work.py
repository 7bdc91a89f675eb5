"""The frozen operation and byte counts against hand counts."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.lib import work  # noqa: E402
from portbench.reference.plain_vit import Arch  # noqa: E402

VIT_S = Arch(embed_dim=384, depth=12, num_heads=6, mlp_dim=1536, image_size=224)


def test_geometry():
    assert (VIT_S.seq_len, VIT_S.head_dim) == (197, 64)


def test_vit_s_forward_flops_by_hand():
    # patch 196 x 768 x 384; per block qkv 384x1152, proj 384x384, fc1 and fc2
    # 384x1536 at 197 rows, QK^T and PV 2 x 197^2 x 384; head 384 x 10
    gemm = 196 * 768 * 384 + 12 * 197 * (384 * 1152 + 384 * 384 + 2 * 384 * 1536)
    attn = 12 * 2 * 197 * 197 * 384
    want = 2 * (gemm + attn + 384 * 10)
    assert work.vit_forward_flops(VIT_S) == want
    assert work.vit_forward_flops(VIT_S) == pytest.approx(9.2e9, rel=0.01)  # timm's 4.6 GMAC
    # training: 3x the forward, ~27.6 GFLOP an image, 7.07 TFLOP a batch-256 step
    assert work.train_step_least_s(VIT_S, 256) * work.PEAK_OPS["bf16"] == pytest.approx(
        7.07e12, rel=0.01)


def test_attention_works_by_hand():
    fwd, bwd = work.attn_train_works(VIT_S, 256)
    assert fwd["ops"] == 4 * 256 * 6 * 197 ** 2 * 64
    assert fwd["bytes"] == 2 * 256 * 197 * 1152 + 2 * 256 * 197 * 384
    assert bwd["ops"] == 10 * 256 * 6 * 197 ** 2 * 64
    assert bwd["bytes"] == 2 * (256 * 197 * 1152 * 2 + 256 * 197 * 384)
    # bytes bound both: 46 us and 81 us
    assert work.roofline(fwd)[1] == "bytes" and work.roofline(fwd)[0] == pytest.approx(0.0462, abs=1e-3)
    assert work.roofline(bwd)[0] == pytest.approx(0.0809, abs=1e-3)


def test_vit_serving_works_by_hand():
    gemms = work.serve_gemm_works(VIT_S, 256)
    assert len(gemms) == 1 + 4 * 12 + 1
    m = 256 * 197
    assert gemms[-1]["ops"] == 2 * 256 * 384 * 10  # the head on the cls rows
    blocks = 12 * 2 * m * (384 * 1152 + 384 * 384 + 2 * 384 * 1536)
    assert sum(w["ops"] for w in gemms[1:-1]) == blocks
    # one batch's least time: ~1.28 ms (int8 GEMMs at 1,979 T, attention at 989 T)
    assert work.serve_least_s(VIT_S, 256) == pytest.approx(1.28e-3, rel=0.05)


def test_roofline_sums_each_work_at_its_peak():
    a = {"ops": 989e9, "type": "bf16", "bytes": 0}
    b = {"ops": 1979e9, "type": "int8", "bytes": 0}
    assert work.roofline(a, b)[0] == pytest.approx(2.0)  # ms
    c = {"ops": 0, "type": "f32", "bytes": 3.35e9}
    assert work.roofline(c) == (pytest.approx(1.0), "bytes")
