"""K2d (LayerNorm -> shifted int8, ``ops.fused_serve.ln_quantize``) on the CPU.

``csrc/ln_quantize.cu`` runs only on the card, so its arithmetic is held here
through a Python model of it (``chip_smoke.py`` and
``tests/test_torch_port_cuda.py`` hold the kernel itself to its plain version):

- the plan: ``ln_quantize_plan``, the mirror of the kernel's ``ln_plan``, picks the
  register form (a warp holds its row, ``nv`` vectors of 8 or 16 bytes a lane) or
  the strided form, by width, element size and alignment;
- a model of both forms' lane mapping and arithmetic (per-lane f64 sums in the
  kernel's order, the butterfly warp sum, ``row_stats_f64``'s ``div_n`` and
  ``rstd_f32``, the f32 affine step, the quantize by adding 1.5 * 2^23 and the
  packed bytes) is
  identical to ``ln_quantize_plain`` for bf16 and f32 rows of 384, 576, 768, 1,024,
  an odd width and one past the register plan, at M 1 and M not a multiple of a
  block's rows; the persistent schedule visits every row once;
- ``div_n`` (two fmas from RN(1 / N)) is the f64 division ``/ N``, near the
  rounding midpoints too, and ``rstd_f32``'s guard takes ``rsqrt``'s value only
  where its f32 rounding is that of ``1 / sqrt``;
- the wrapper's launch arguments (the data pointer, whose alignment the kernel's
  plan reads) and its launch count, from a recording stand-in for the kernel
  library.

The plain version against JAX's K2d in interpret mode at these widths is
``tests/test_torch_port_ops.py::test_ln_quantize_matches_pallas``.
"""

import math
import os
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops import fused_serve as fs

WIDTHS = [384, 576, 768, 1024, 385, 1280]
OUT_Q = {"scale": np.float32(8.0 / 255), "zero_point": np.float32(128.0)}
# warps per block of the register form, as csrc/ln_quantize.cu has it
REG_WARPS = int(re.search(r"constexpr int REG_WARPS = (\d+);",
                          open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                                            "ln_quantize.cu")).read()).group(1))


def _case(m, n, dtype, seed):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.normal(0.3, 1.5, (m, n)).astype(np.float32)).to(dtype)
    ln = {"scale": torch.from_numpy(r.normal(1, 0.2, n).astype(np.float32)),
          "bias": torch.from_numpy(r.normal(0, 0.2, n).astype(np.float32))}
    return x, ln


def _warp_sum(parts):
    """``qvt::warp_sum`` over 32 lanes: the xor butterfly, in f64."""
    v = np.array(parts, dtype=np.float64)
    for o in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ o]
    return v[0]


def _fma(x, y, z):
    """fma in f64: the exact x * y + z rounded once."""
    return float(Fraction(x) * Fraction(y) + Fraction(z))


def _div_n(a, n):
    """``div_n``: q = RN(a / RN(1/n)'s product), r = a - q n (exact), RN(q + r / n)."""
    inv_n = 1.0 / n
    q = a * inv_n
    return _fma(_fma(-q, n, a), inv_n, q) if math.isfinite(q) else q


def _rstd_guard(y):
    """``rstd_f32``'s test: the f32 roundings of y (1 -+ 2^-49) agree."""
    return np.float32(y * (1.0 - 2.0 ** -49)) == np.float32(y * (1.0 + 2.0 ** -49))


def _rstd_f32(v):
    """``rstd_f32``: the f32 rounding of 1 / sqrt(v) in f64 (the guard makes
    ``rsqrt``'s path give the same, :func:`test_rstd_guard_keeps_the_rounding`)."""
    return np.float32(1.0 / math.sqrt(v))


def _quantize_bits(z, inv_s, zp, qmax):
    """``quantize_bits``: the f32 bits of rint(clamp(z * inv_s + zp)) + 1.5 * 2^23
    (``np.fmax`` / ``np.fmin``: a NaN gives the other operand, as fmaxf does)."""
    t = np.fmin(np.fmax((z * inv_s).astype(np.float32) + zp, np.float32(0)), qmax)
    return (t.astype(np.float32) + np.float32(12582912.0)).astype(np.float32).view(np.uint32)


def _lane_columns(n, elem, align=16):
    """The columns each lane holds, in the order it sums them, and the form."""
    vec, nv = fs.ln_quantize_plan(n, elem, align)
    if vec == 0:  # strided: lane l takes columns l, l + 32, ...
        return [list(range(lane, n, 32)) for lane in range(32)], (0, 0)
    e = vec // elem
    nvec = n // e
    cols = [[(v * 32 + lane) * e + k for v in range(nv) if v * 32 + lane < nvec
             for k in range(e)] for lane in range(32)]
    return cols, (vec, nv)


def model(x: torch.Tensor, ln, out_q, eps=1e-6, quant_max=255.0):
    """The kernels' arithmetic, lane by lane (see the module docstring)."""
    m, n = x.shape
    xf = x.to(torch.float32).numpy()
    g, b = ln["scale"].numpy(), ln["bias"].numpy()
    cols, _ = _lane_columns(n, x.element_size())
    inv_s, zp, qmax = np.float32(fs.inv_scale(out_q["scale"])), np.float32(out_q["zero_point"]), \
        np.float32(quant_max)
    q = np.zeros((m, n), np.int8)
    for row in range(m):
        xr = xf[row]
        parts = [sum((float(xr[c]) for c in lane_cols), 0.0) for lane_cols in cols]
        mean = _div_n(_warp_sum(parts), n)
        parts = [sum(((float(xr[c]) - mean) ** 2 for c in lane_cols), 0.0) for lane_cols in cols]
        var = _div_n(_warp_sum(parts), n)
        rstd = _rstd_f32(var + float(np.float32(eps)))
        mean32 = np.float32(mean)
        z = (((xr - mean32).astype(np.float32) * rstd).astype(np.float32) * g).astype(
            np.float32) + b
        bits = _quantize_bits(z.astype(np.float32), inv_s, zp, qmax)
        q[row] = ((bits & 0xFF) ^ 0x80).astype(np.uint8).view(np.int8)
    return torch.from_numpy(q)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 6])
def test_model_identical_to_plain(n, dtype, m):
    """Both forms' lane mapping and arithmetic give ``ln_quantize_plain``'s bits
    (6 rows: not a multiple of a block's 4 or 8)."""
    x, ln = _case(m, n, dtype, n + m)
    np.testing.assert_array_equal(model(x, ln, OUT_Q).numpy(),
                                  fs.ln_quantize_plain(x, ln, OUT_Q).numpy())


@pytest.mark.parametrize("n", WIDTHS + [1, 3, 1023])
def test_div_n_is_the_division(n):
    """``div_n`` gives a / n rounded once, for sums of every scale, sums of
    bf16 rows, and a / n within an f64 ulp of a rounding midpoint."""
    r = np.random.default_rng(n)
    sums = [float(v) for v in r.uniform(-1, 1, 1500) * 2.0 ** r.integers(-140, 60, 1500)]
    sums += [float(r.normal(0.3, 1.5, n).astype(np.float32).astype(np.float64).sum())
             for _ in range(50)]
    for q in r.uniform(1, 2, 1500) * 2.0 ** r.integers(-100, 40, 1500):
        sums.append(float((Fraction(float(q)) + Fraction(math.ulp(float(q))) / 2) * n))
    sums += [0.0, -0.0, math.inf, -math.inf]
    for a in sums:
        assert _div_n(a, n) == a / n, (a.hex(), n)
    assert math.isnan(_div_n(math.nan, n))


def test_rstd_guard_keeps_the_rounding():
    """Where the guard takes ``rsqrt``'s value y (up to 3 ulps from the f64
    1 / sqrt(v)), y's f32 rounding is that of 1 / sqrt(v); near an f32
    midpoint the guard sends the row to the square root and division."""
    r = np.random.default_rng(7)
    vs = list(r.uniform(0.5, 2, 3000) * 2.0 ** r.integers(-60, 60, 3000))
    for t in r.uniform(0.5, 2, 3000) * 2.0 ** r.integers(-20, 20, 3000):
        t32 = np.float32(t)
        mid = float(t32) + float(np.spacing(t32)) / 2
        vs.append(1.0 / (mid * mid))
    taken = sent = 0
    for v in vs:
        exact = 1.0 / math.sqrt(v)
        for k in (-3, -2, -1, 0, 1, 2, 3):
            y = exact
            for _ in range(abs(k)):
                y = math.nextafter(y, math.copysign(math.inf, k))
            if _rstd_guard(y):
                taken += 1
                assert np.float32(y) == _rstd_f32(v), (v, k)
            else:
                sent += 1
    assert taken > 3000 * 7 * 0.99 and sent > 0
    assert _rstd_guard(math.inf)  # v = 0: rsqrt gives inf, as 1 / sqrt(0) does
    assert not _rstd_guard(math.nan)  # NaN: the square root and division


def test_plan():
    """The register form for the widths it holds (ViT-S/B/L, OWLv2's 576 and
    768): the vector width whose lanes hold the fewest slots, the wider on a
    tie; the strided form past 32 slots a lane, for N % 4 != 0, and for
    vectors the pointer's alignment cannot take."""
    plan = fs.ln_quantize_plan
    assert [plan(n, 2) for n in WIDTHS] == [(8, 3), (8, 5), (16, 3), (16, 4), (0, 0), (0, 0)]
    assert [plan(n, 4) for n in WIDTHS] == [(16, 3), (16, 5), (16, 6), (16, 8), (0, 0), (0, 0)]
    assert plan(384, 2, 8) == (8, 3) and plan(768, 2, 8) == (8, 6)
    assert plan(384, 4, 8) == (0, 0) and plan(384, 2, 4) == (0, 0)
    assert plan(386, 2) == plan(386, 4) == (0, 0)  # N % 4
    assert plan(4, 2) == (8, 1) and plan(4, 4) == (16, 1)
    for n in range(4, 1100, 4):
        for elem in (2, 4):
            vec, nv = plan(n, elem)
            if vec:
                e = vec // elem
                assert n % e == 0 and nv == -(-(n // e) // 32) and nv * e <= fs.LN_REG_SLOTS
            else:
                assert n > 32 * fs.LN_REG_SLOTS, (n, elem)
    cols, _ = _lane_columns(576, 2)
    assert sorted(c for lane in cols for c in lane) == list(range(576))
    # lane 0 holds vectors 0, 32, 64, 96, 128 of 4 bf16: columns 0-3, 128-131, ...
    assert cols[0][:8] == [0, 1, 2, 3, 128, 129, 130, 131] and len(cols[16]) == 16


def test_quantize_bits_is_rint_and_clamp():
    """Adding 1.5 * 2^23 rounds half to even and clamping first gives the same
    integer, over values on and between the half steps, negative, past qmax,
    and NaN (0, as ``quantize_shifted``'s fmaxf gives)."""
    t = np.concatenate([np.arange(-600, 1200, dtype=np.float32) * np.float32(0.25),
                        np.random.default_rng(0).uniform(-3, 300, 10_000).astype(np.float32),
                        np.array([np.nan, -0.0, 254.5, 255.5, 0.5, 1.5], np.float32)])
    for qmax in (np.float32(255), np.float32(127)):
        bits = _quantize_bits(t, np.float32(1), np.float32(0), qmax)
        want = np.clip(np.rint(np.nan_to_num(t, nan=0.0)), 0, qmax).astype(np.int64)
        np.testing.assert_array_equal(bits & 0xFF, want)
        np.testing.assert_array_equal(bits >> 8, 0x4B4000)


@pytest.mark.parametrize("m", [1, 6304, 50432])
def test_persistent_schedule_visits_every_row_once(m):
    """Warp w of the register form walks rows w, w + W, ... (W the grid's
    warps: min(ceil(M / 4) blocks, what is resident)), each row once."""
    for resident in (132 * 5, 132 * 8):
        grid = min(-(-m // REG_WARPS), resident)
        warps = grid * REG_WARPS
        seen = np.zeros(m, np.int64)
        for w in range(min(warps, m)):
            seen[w::warps] += 1
        assert (seen == 1).all()


class _Recorder:
    """A stand-in kernel library: records each entry point's arguments."""

    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        assert len(args) == len(_build._SIGNATURES[name]), (name, len(args))
        self.calls.append((name, args))


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "load", lambda: rec)
    monkeypatch.setattr(fs, "use_plain", lambda t: False)
    monkeypatch.setattr(fs, "stream_of", lambda dev: 0)
    return rec


@pytest.mark.parametrize("n,dtype,form", [
    (384, torch.bfloat16, (8, 3)), (384, torch.float32, (16, 3)), (576, torch.bfloat16, (8, 5)),
    (1024, torch.float32, (16, 8)), (385, torch.bfloat16, (0, 0)), (1280, torch.float32, (0, 0))])
def test_launch_arguments(recorder, n, dtype, form):
    """``qvt_ln_quantize`` gets the pointers, the rows and width, the dtype
    flag, 1/scale in f32, the zero point, qmax and eps; the form the kernel's
    plan picks there (its mirror, at the pointer's alignment); one count per
    launch, none for an empty input."""
    x, ln = _case(37, n, dtype, 1)
    x = x.reshape(1, 37, n)
    before = fs.ln_quantize.launches
    q = fs.ln_quantize(x, ln, {"scale": torch.tensor(0.03), "zero_point": torch.tensor(121.0)},
                       eps=1e-5)
    name, args = recorder.calls[-1]
    assert name == "qvt_ln_quantize" and q.shape == x.shape and q.dtype == torch.int8
    assert args[:4] == (x.data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(), q.data_ptr())
    assert args[4:7] == (37, n, int(dtype == torch.bfloat16))
    assert fs.ln_quantize_plan(n, x.element_size(), fs.pointer_align(x)) == form
    assert args[7:11] == (fs.inv_scale(0.03), 121.0, 255.0, 1e-5)
    assert fs.ln_quantize.launches == before + 1
    fs.ln_quantize(x[:, :0], ln, OUT_Q)
    assert fs.ln_quantize.launches == before + 1 and len(recorder.calls) == 1


def test_launch_takes_the_strided_form_off_alignment(recorder):
    """A row view 8 bytes off a 16-byte boundary takes 8-byte vectors (bf16)
    or the strided form (f32)."""
    ln = _case(1, 384, torch.float32, 2)[1]
    for dtype, form in ((torch.bfloat16, (8, 3)), (torch.float32, (0, 0))):
        base = torch.zeros(3 * 384 + 8 // torch.tensor([], dtype=dtype).element_size(),
                           dtype=dtype)
        x = base[8 // base.element_size():][:3 * 384].view(3, 384)
        assert x.data_ptr() % 16 == 8 and fs.pointer_align(x) == 8
        fs.ln_quantize(x, ln, OUT_Q)
        assert recorder.calls[-1][1][0] == x.data_ptr()
        assert fs.ln_quantize_plan(384, x.element_size(), fs.pointer_align(x)) == form
