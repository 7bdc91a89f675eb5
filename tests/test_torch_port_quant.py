"""Port parity: observers, qparams and fake-quant of ``qat_vit_tpu_torch.quant``
against ``qat_vit_tpu.quant``.

The same f32 inputs (numpy, seeded) go through both packages. Everything
here is elementwise f32 arithmetic in the same order, or an order statistic,
so min/max, scale, zero-point and fake-quant outputs must be IDENTICAL.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from qat_vit_tpu.quant import fake_quant as jfq
from qat_vit_tpu.quant import observers as jobs
from qat_vit_tpu_torch.quant import fake_quant as tfq
from qat_vit_tpu_torch.quant import observers as tobs
from qat_vit_tpu_torch.quant.modules import FakeQuantizer
from qat_vit_tpu_torch.quant.qconfig import default_qat_qconfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _ranges(n=64, seed=0):
    """(min, max) pairs: straddling zero, one-sided, tiny, zero and uninitialized."""
    rng = np.random.default_rng(seed)
    pairs = [(float(a), float(b)) for a, b in zip(rng.uniform(-5, 0, n), rng.uniform(0, 5, n))]
    pairs += [(0.3, 2.0), (-2.0, -0.1), (-0.004, 0.004), (-1e-6, 2e-6), (0.0, 0.0),
              (np.inf, -np.inf), (-0.0156, 0.0), (1.0, 1.0)]
    return [(np.float32(a), np.float32(b)) for a, b in pairs]


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


@pytest.mark.parametrize("fn", ["qparams_affine", "qparams_symmetric",
                                "qparams_fused_affine", "qparams_fused_symmetric"])
@pytest.mark.parametrize("grid", [(0, 255), (0, 127), (-128, 127)])
def test_qparams_identical(fn, grid):
    qmin, qmax = grid
    for lo, hi in _ranges():
        js, jz = getattr(jobs, fn)(jnp.float32(lo), jnp.float32(hi), qmin, qmax)
        ts, tz = getattr(tobs, fn)(torch.tensor(lo), torch.tensor(hi), qmin, qmax)
        assert _np(ts) == np.asarray(js), (fn, lo, hi)
        assert _np(tz) == np.asarray(jz), (fn, lo, hi)


def test_per_channel_qparams_identical():
    w = np.random.default_rng(1).normal(0, 0.05, (96, 40)).astype(np.float32)
    js, _ = jobs.qparams_symmetric_per_channel(jnp.asarray(w), axis=1)
    ts, tz = tobs.qparams_symmetric_per_channel(torch.from_numpy(w), axis=1)
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    assert (_np(tz) == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ema_minmax_sequence_identical(dtype):
    """First call initializes from the batch, later calls take the c=0.01 EMA;
    min/max are reduced in the input dtype, which is exact."""
    rng = np.random.default_rng(2)
    jmin, jmax = jobs.MinMaxState.init()
    tmin, tmax = torch.tensor(np.inf), torch.tensor(-np.inf)
    for step in range(6):
        x = (rng.normal(0, 1 + step, (8, 17, 32)) + step).astype(np.float32)
        jmin, jmax = jobs.update_moving_avg_minmax(jmin, jmax, jnp.asarray(x).astype(dtype))
        tmin, tmax = tobs.update_moving_avg_minmax(tmin, tmax,
                                                   torch.from_numpy(x).to(getattr(torch, dtype)))
        assert _np(tmin) == np.asarray(jmin) and _np(tmax) == np.asarray(jmax), step


@pytest.mark.parametrize("symmetric,qmin,qmax", [(False, 0, 255), (True, -128, 127),
                                                 (False, 0, 127)])
def test_fused_obs_fake_quant_identical(symmetric, qmin, qmax):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (4, 17, 64)).astype(np.float32)
    kw = dict(symmetric=symmetric, quant_min=qmin, quant_max=qmax)
    # observing step from the uninitialized state
    jy, jmin, jmax = jfq.fused_moving_avg_obs_fake_quant(
        jnp.asarray(x), jnp.float32(np.inf), jnp.float32(-np.inf), observe=True, **kw)
    ty, tmin, tmax = tfq.fused_moving_avg_obs_fake_quant(
        torch.from_numpy(x), torch.tensor(np.inf), torch.tensor(-np.inf), observe=True, **kw)
    np.testing.assert_array_equal(_np(ty), np.asarray(jy))
    assert _np(tmin) == np.asarray(jmin) and _np(tmax) == np.asarray(jmax)
    # frozen step on new data
    x2 = (x * 1.5).astype(np.float32)
    jy2, _, _ = jfq.fused_moving_avg_obs_fake_quant(jnp.asarray(x2), jmin, jmax,
                                                    observe=False, **kw)
    ty2, _, _ = tfq.fused_moving_avg_obs_fake_quant(torch.from_numpy(x2), tmin, tmax,
                                                    observe=False, **kw)
    np.testing.assert_array_equal(_np(ty2), np.asarray(jy2))


def test_identity_until_observed():
    """An eval-mode site that never observed passes the tensor through."""
    x = np.random.default_rng(4).normal(0, 3, (2, 5, 8)).astype(np.float32)
    fq = FakeQuantizer(default_qat_qconfig().activation)
    y = fq(torch.from_numpy(x), observe=False)
    np.testing.assert_array_equal(_np(y), x)
    assert torch.isinf(fq.min_val) and torch.isinf(fq.max_val)
    fq(torch.from_numpy(x), observe=True)
    assert float(fq.min_val) == x.min() and float(fq.max_val) == x.max()
    assert not np.array_equal(_np(fq(torch.from_numpy(x), observe=False)), x)


def test_quantize_to_int_and_dequantize_identical():
    rng = np.random.default_rng(5)
    # exact .5 ties exercise round-half-to-even
    x = np.concatenate([rng.normal(0, 1, 256), np.arange(-4, 4, 0.5) * 0.1]).astype(np.float32)
    s, zp = np.float32(0.1), np.float32(3.0)
    jq = jfq.quantize_to_int(jnp.asarray(x), jnp.float32(s), jnp.float32(zp), -128, 127)
    tq = tfq.quantize_to_int(torch.from_numpy(x), s.item(), zp.item(), -128, 127)
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    jd = jfq.dequantize(jq, jnp.float32(s), jnp.float32(zp))
    td = tfq.dequantize(tq, s.item(), zp.item())
    np.testing.assert_array_equal(_np(td), np.asarray(jd))


@pytest.mark.parametrize("backend", ["qnnpack", "fbgemm"])
def test_default_qconfig_matches(backend):
    from qat_vit_tpu.quant.qconfig import default_qat_qconfig as jqc

    j, t = jqc(backend), default_qat_qconfig(backend)
    for side in ("activation", "weight"):
        a, b = getattr(j, side), getattr(t, side)
        assert (a.quant_min, a.quant_max, a.symmetric, a.averaging_constant) == (
            b.quant_min, b.quant_max, b.symmetric, b.averaging_constant)
    with pytest.raises(ValueError):
        default_qat_qconfig("nope")
