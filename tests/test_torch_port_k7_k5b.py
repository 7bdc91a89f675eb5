"""K7 on Hopper's TMA and ``wgmma`` and the f32 K5b on kernel B's passes,
rehearsed on the CPU.

K7 (``pallas_gemm.py::_kernel``) runs ``qvt_quantize_gemm``
(``csrc/int8_gemm_wgmma.cu``): a block quantizes a strip of 64 rows of x
(at most 1,536 k bytes at once; a longer K in chunks) into shared memory,
K-major in 128-byte rows with the 128-byte swizzle, and sweeps units of 384
columns (one 128-column tile per consumer warpgroup) with the packed weight
``[N, K]`` streamed by TMA in 128-byte k-steps, zero-filled past N and K.
The f32 K5b (``long_attention.py::_long_attention_bwd_kernel``) runs kernel
B's rows and keys passes (``csrc/attention_f32.cu``) with K5b's arithmetic:
q scaled before the score dot, dk from the unscaled q, ``do`` rows past
``n_valid`` taken as zero. This file holds:

- a model of K7's tiling (the strip's quantize and swizzled layout read
  back as the hardware unswizzles it, k-steps, the zero-filled K tail, the
  units over N) identical to ``fused_quantize_matmul_plain`` and within
  XLA's FMA contraction of JAX's ``fused_quantize_matmul(interpret=True)``:
  K 96 / 384 / 480 / 1,536 (and 1,664, two chunks), M = 2·197, f32 and bf16
  x, per-tensor and per-channel, f32 and bf16 out;
- a model of kernel B's two passes under K5b's arithmetic (R 8 and 4 rows
  per block, ``n_valid`` < N) identical to ``long_attention_bwd_plain``
  and within 2e-4 of JAX's ``long_attention_train`` VJP in interpret mode;
- the f32 K5b gate against JAX's cap over N <= 4,096 and hd 8..128;
- both wrappers' launch arguments through a recording stand-in, ``w_t``
  from the export included.

Inputs are numpy, seeded, and go to both packages.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qat_vit_tpu.ops import pallas_gemm as jax_pallas_gemm
from qat_vit_tpu.ops.long_attention import long_attention_train as jax_long_attention_train
from qat_vit_tpu.ops.long_attention import (
    long_attention_train_available as jax_long_attention_train_available,
)
from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops import fused_serve as fs
from qat_vit_tpu_torch.ops import long_attention as la
from qat_vit_tpu_torch.ops import pallas_gemm as pg
from qat_vit_tpu_torch.ops import quantized_matmul as qm
from qat_vit_tpu_torch.ops._cuda import bwd_scale_f32
from qat_vit_tpu_torch.ops.flash_attention import attention_f32_rows, split_heads
from qat_vit_tpu_torch.ops.quantized_matmul import f32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32, BF16 = torch.float32, torch.bfloat16
M = 2 * 197
# csrc/int8_gemm_wgmma.cu's K7 plan
ROWS, BK, TILE_N, UNIT_N, MAX_CHUNK = 64, 128, 128, 384, 1536
IN_Q = {"scale": np.float32(4.0 / 255), "zero_point": np.float32(100.0)}


def _k7_case(k, n, per_channel, x_dt, seed):
    rng = np.random.default_rng(seed + k + n)
    x = rng.normal(0, 1.5, (M, k)).astype(np.float32)
    if x_dt == BF16:  # values bf16 holds exactly, the same in both packages
        x = torch.from_numpy(x).to(BF16).float().numpy()
    w = np.clip(np.round(rng.normal(0, 20, (k, n))), -128, 127).astype(np.int8)
    ws = rng.uniform(1e-3, 3e-3, n).astype(np.float32) if per_channel else np.float32(0.002)
    layer = {"w_int8": w, "w_colsum": w.astype(np.int32).sum(0, dtype=np.int32),
             "bias": rng.normal(0, 0.5, n).astype(np.float32), "w_scale": ws}
    return x, layer


def _unswizzle(buf, tile):
    """The [64, 128] K-major tile at byte ``tile`` of ``buf`` as the TMA /
    wgmma 128-byte swizzle reads it: logical 16-byte chunk c of row r lies
    at chunk c ^ (r % 8)."""
    r = np.arange(ROWS)[:, None]
    byte = np.arange(BK)[None, :]
    phys = tile + r * BK + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15))
    return buf[phys]


def k7_model(x, w_q, *, x_scale, x_zero_point, w_scale, w_colsum, bias=None,
             x_quant_max=255.0, out_dtype=F32):
    """quantize_gemm_kernel's tiling, in its order → [M, N] ``out_dtype``."""
    m, k = x.shape
    n = w_q.shape[1]
    w_t = fs.pack_k_major(w_q)
    nk = -(-k // BK)
    chunk = min(nk * BK, MAX_CHUNK)
    ck = chunk // BK
    inv_s, zp, qmax = fs.inv_scale(x_scale), f32(x_zero_point), f32(x_quant_max)
    xf = x.to(F32)
    y = torch.empty(m, n, dtype=F32)
    for m0 in range(0, m, ROWS):
        rows = min(ROWS, m - m0)
        for u0 in range(0, n, UNIT_N):
            for n0 in range(u0, u0 + UNIT_N, TILE_N):
                if n0 >= n:  # the unit's second tile past N computes nothing
                    continue
                acc = torch.zeros(ROWS, TILE_N, dtype=torch.int64)
                for c0 in range(0, nk, ck):
                    # the strip: zeros past M and past K, swizzled 16-byte chunks
                    kl = min(ck, nk - c0) * BK
                    logical = torch.zeros(ROWS, kl, dtype=torch.int8)
                    k1 = min(k, c0 * BK + kl)
                    logical[:rows, :k1 - c0 * BK] = fs.quantize_mul(
                        xf[m0:m0 + rows, c0 * BK:k1], inv_s, zp, qmax)
                    buf = np.zeros(ROWS * kl, np.int8)
                    for kt in range(kl // BK):
                        r = np.arange(ROWS)[:, None]
                        c = np.arange(BK)[None, :]
                        phys = kt * ROWS * BK + r * BK + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15))
                        buf[phys] = logical[:, kt * BK:(kt + 1) * BK].numpy()
                    for kt in range(c0, min(c0 + ck, nk)):
                        a = torch.from_numpy(_unswizzle(buf, (kt - c0) * ROWS * BK)).long()
                        # W's stage: TMA's zero fill past N and past K
                        b = torch.zeros(TILE_N, BK, dtype=torch.int64)
                        wt = w_t[n0:n0 + TILE_N, kt * BK:(kt + 1) * BK]
                        b[:wt.shape[0], :wt.shape[1]] = wt.long()
                        acc += a @ b.T
                cols = min(TILE_N, n - n0)
                y[m0:m0 + rows, n0:n0 + cols] = _epilogue(
                    acc[:rows, :cols], x_scale, x_zero_point, w_scale, w_colsum, bias, n0, cols)
    return y.to(out_dtype)


def _epilogue(acc, x_scale, x_zero_point, w_scale, w_colsum, bias, n0, cols):
    """The PLAIN epilogue of one tile: (acc − z_s·colsum)·(s_x·w_scale) + bias in f32."""
    z_s = int(f32(x_zero_point)) - 128
    a = acc.to(torch.int32) - z_s * w_colsum[n0:n0 + cols].to(torch.int32)
    if qm.is_per_channel(w_scale):
        sw = w_scale[n0:n0 + cols].to(F32) * f32(x_scale)
    else:
        sw = float(np.float32(f32(x_scale)) * np.float32(f32(w_scale)))
    out = a.to(F32) * sw
    return out + bias[n0:n0 + cols] if bias is not None else out


@pytest.mark.parametrize("k,n,per_channel,x_dt,out_dt", [
    (96, 384, False, F32, F32), (96, 128, True, BF16, BF16),
    (384, 1152, True, F32, F32), (384, 384, False, BF16, F32),
    (480, 384, True, F32, BF16), (480, 640, False, BF16, F32),
    (1536, 384, False, F32, F32), (1536, 256, True, BF16, BF16),
    (1664, 128, False, F32, F32)])
def test_k7_tile_model(k, n, per_channel, x_dt, out_dt):
    """The model of K7's tiling is identical to ``fused_quantize_matmul_plain``
    (M = 2·197: a ragged last strip; N 128, 256 and 640: a unit whose last
    tiles lie past N; K 96 and 480: a zero-filled k-step tail; K 1,664: two
    chunks), and within XLA's contraction of the dequant into an FMA (1e-6
    rel, as tests/test_torch_port_gemm_k32.py) of JAX's Pallas kernel in
    interpret mode, which writes f32 and casts."""
    x, layer = _k7_case(k, n, per_channel, x_dt, 0)
    tl = {key: torch.from_numpy(np.asarray(v)) for key, v in layer.items()}
    kw = dict(x_scale=torch.tensor(IN_Q["scale"]), x_zero_point=torch.tensor(IN_Q["zero_point"]),
              w_scale=tl["w_scale"], w_colsum=tl["w_colsum"], bias=tl["bias"], out_dtype=out_dt)
    xt = torch.from_numpy(x).to(x_dt)
    got = k7_model(xt, tl["w_int8"], **kw)
    plain = pg.fused_quantize_matmul_plain(xt, tl["w_int8"], **kw)
    assert got.dtype == plain.dtype == out_dt and torch.equal(got, plain)
    want = jax_pallas_gemm.fused_quantize_matmul(
        jnp.asarray(x, jnp.bfloat16 if x_dt == BF16 else jnp.float32), jnp.asarray(layer["w_int8"]),
        x_scale=IN_Q["scale"], x_zero_point=IN_Q["zero_point"],
        w_scale=jnp.asarray(layer["w_scale"]), w_colsum=jnp.asarray(layer["w_colsum"]),
        bias=jnp.asarray(layer["bias"]), out_dtype=jnp.float32, interpret=True)
    got32 = k7_model(xt, tl["w_int8"], **{**kw, "out_dtype": F32})
    np.testing.assert_allclose(got32.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# K5b in f32 on kernel B's passes
# ---------------------------------------------------------------------------

KT, KEYS, QT = 64, 32, 64  # kernel B's key tile, keys pass block, query tile


def _dot_d(a, b):
    """G1: a [..., r, hd] · b [..., c, hd]ᵀ from +0, one d at a time."""
    s = torch.zeros(a.shape[:-1] + b.shape[-2:-1], dtype=F32)
    for d in range(a.shape[-1]):
        s = s + a[..., d:d + 1] * b[..., d].unsqueeze(-2)
    return s


def _g2(acc, a, b, kn):
    """G2: acc + a[..., :, :kn] · b[..., :kn, :], one k at a time."""
    for k in range(kn):
        acc = acc + a[..., k:k + 1] * b[..., k:k + 1, :]
    return acc


def _pad(x, rows):
    return torch.cat([x, x.new_zeros(x.shape[:-2] + (rows - x.shape[-2], x.shape[-1]))], -2)


def _warp_sum(x):
    """The f64 sum over the last dim in a warp's order (lane-strided, then xor)."""
    n32 = -(-x.shape[-1] // 32) * 32
    xp = torch.cat([x, x.new_zeros(x.shape[:-1] + (n32 - x.shape[-1],))], -1)
    part = torch.zeros(x.shape[:-1] + (32,), dtype=torch.float64)
    for t in range(0, n32, 32):
        part = part + xp[..., t:t + 32]
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        part = part + part[..., lane ^ o]
    return part[..., :1]


def k5b_model(qkv, do, h, hd, n_valid, rows):
    """Kernel B's rows and keys passes under the K5b flag → dqkv [B, N, 3·H·hd]."""
    b, n, _ = qkv.shape
    q, k, v = split_heads(qkv, h, hd)
    qs = q * torch.tensor(hd ** -0.5, dtype=F32)  # staged scaled (rows) / scaled at G1's load (keys)
    g = do.reshape(b, n, h, hd).transpose(1, 2).clone()
    g[:, :, n_valid:] = 0  # staged as zeros
    scale = bwd_scale_f32(hd, "cpu")
    n4 = -(-n // 4) * 4
    stats = torch.empty(3, b, h, n, dtype=torch.float64)
    dq, dk, dv = (torch.empty(b, h, n, hd) for _ in range(3))
    for i0 in range(0, n, rows):  # the rows pass, G1 on the narrow form
        rws = min(rows, n - i0)
        ss, ds = torch.zeros(b, h, rws, n4), torch.zeros(b, h, rws, n4)
        for k0 in range(0, n, KT):
            cols = min(KT, n - k0)
            s = _dot_d(qs[:, :, i0:i0 + rws], _pad(k[:, :, k0:k0 + cols], KT))
            s = s.masked_fill(torch.arange(k0, k0 + KT) >= n_valid, -1e30)
            dp = _dot_d(g[:, :, i0:i0 + rws], _pad(v[:, :, k0:k0 + cols], KT))
            ss[..., k0:k0 + cols], ds[..., k0:k0 + cols] = s[..., :cols], dp[..., :cols]
        x, dp = ss[..., :n], ds[..., :n]
        e = torch.exp((x - x.amax(-1, keepdim=True)).double()).float()
        l = _warp_sum(e.double())
        p = (e.double() / l).float()
        r = _warp_sum((dp * p).double()).float()
        ds[..., :n] = p * (dp - r)
        stats[:, :, :, i0:i0 + rws] = torch.stack(
            [x.amax(-1).double(), l[..., 0], r[..., 0].double()])
        acc = torch.zeros(b, h, rws, hd)
        for k0 in range(0, n, 2 * KT):
            kt = _pad(k[:, :, k0:k0 + min(2 * KT, n - k0)], 2 * KT)
            acc = _g2(acc, ds[..., k0:], kt, min(2 * KT, n4 - k0))
        dq[:, :, i0:i0 + rws] = acc * scale
    m, l, r = stats[0].float(), stats[1], stats[2].float()
    for j0 in range(0, n, KEYS):  # the keys pass
        keys = min(KEYS, n - j0)
        kc, vc = (_pad(t[:, :, j0:j0 + keys], KEYS) for t in (k, v))
        ak, av = torch.zeros(b, h, KEYS, hd), torch.zeros(b, h, KEYS, hd)
        for q0 in range(0, n, QT):
            nq = min(QT, n - q0)
            qt, qst, gt = (_pad(t[:, :, q0:q0 + nq], QT) for t in (q, qs, g))
            st = _dot_d(kc, qst).masked_fill((torch.arange(j0, j0 + KEYS) >= n_valid)[:, None],
                                             -1e30)
            dpt = _dot_d(vc, gt)
            mq, lq, rq = (torch.cat([t[..., q0:q0 + nq], t.new_ones(b, h, QT - nq)], -1)
                          .unsqueeze(-2) for t in (m, l, r))
            p = (torch.exp((st - mq).double()).float().double() / lq).float()
            dst = p * (dpt - rq)
            live = torch.arange(QT) < nq
            p, dst = (torch.where(live, t, torch.zeros_like(t)) for t in (p, dst))
            ak = _g2(ak, dst, qt, -(-nq // 4) * 4)  # dk from the unscaled q
            av = _g2(av, p, gt, -(-nq // 4) * 4)
        dk[:, :, j0:j0 + keys] = (ak * scale)[:, :, :keys]
        dv[:, :, j0:j0 + keys] = av[:, :, :keys]
    return torch.cat([t.transpose(1, 2).reshape(b, n, h * hd) for t in (dq, dk, dv)], -1)


def _k5b_case(b, n, h, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, n, 3 * h * hd)).astype(np.float32),
            rng.normal(0, 1, (b, n, h * hd)).astype(np.float32))


@pytest.mark.parametrize("b,n,h,hd,n_valid,rows", [
    (1, 150, 2, 16, 141, 8), (2, 77, 1, 64, 70, 4), (1, 70, 2, 8, 70, 8)])
def test_k5b_tile_model(b, n, h, hd, n_valid, rows):
    """The model of kernel B's passes under the K5b flag gives
    ``long_attention_bwd_plain``'s bits at R 8 and 4 (the plan's R at 2,305
    and 4,096 tokens), padded query rows (``n_valid`` < N, junk ``do``
    there: their dq rows and their +0 to dk and dv, signs of zero
    included) and ragged tiles; its valid rows are within 2e-4 of JAX's
    ``long_attention_train`` VJP in interpret mode on the unpadded qkv (the
    tolerance of tests/test_torch_port_detect_train.py: the same math in
    another summation order)."""
    qkv, do = _k5b_case(b, n, h, hd, n + rows)
    tq, td = torch.from_numpy(qkv), torch.from_numpy(do)
    got = k5b_model(tq, td, h, hd, n_valid, rows)
    assert torch.equal(got, la.long_attention_bwd_plain(tq, td, h, hd, n_valid=n_valid))
    jgrad = jax.grad(lambda v: (jax_long_attention_train(v, h, hd, 128, True)
                                * do[:, :n_valid]).sum())(jnp.asarray(qkv[:, :n_valid]))
    np.testing.assert_allclose(got[:, :n_valid].numpy(), np.asarray(jgrad), rtol=2e-4, atol=2e-4)


def test_k5b_f32_gate_matches_jax(monkeypatch):
    """The f32 K5b gate is kernel B's rows-pass plan: with JAX's cap it
    admits exactly what JAX's ``long_attention_train_available`` admits
    (its kernels in interpret mode, which it needs off the TPU) over N <=
    4,097 and hd 8..128 (multiples of 8; the plan's R at 2,305 tokens is 8
    at hd 64, at 4,096 tokens 4); the plan's own edge moved from 5,024 to
    18,472 tokens at hd 128."""
    monkeypatch.setenv("QVT_ATTN_INTERPRET", "1")
    for hd in range(8, 129, 8):
        for n in (1, 17, 197, 1024, 2305, 3601, 3841, 4096, 4097):
            want = jax_long_attention_train_available(9, hd, seq_len=n)
            assert la.long_attention_train_available(9, hd, n, F32) == want, (hd, n)
            if n <= 4096:
                assert la.long_attention_bwd_shapes_ok(n, hd, F32), (hd, n)
    assert attention_f32_rows(2305, 64, backward=True) == 8
    assert attention_f32_rows(4096, 64, backward=True) == 4
    assert la.long_attention_bwd_shapes_ok(18_472, 128, F32)
    assert not la.long_attention_bwd_shapes_ok(18_473, 128, F32)
    assert not la.long_attention_bwd_shapes_ok(2305, 60, F32)
    assert not la.long_attention_bwd_shapes_ok(2305, 136, F32)


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
    for mod in (pg, la):
        monkeypatch.setattr(mod, "use_plain", lambda t: False)
        monkeypatch.setattr(mod, "stream_of", lambda dev: 0)
    return rec


def test_k7_launch_arguments(recorder):
    """K7 hands ``qvt_quantize_gemm`` the packed weight: ``w_t`` as given
    (``quantized_dense`` passes the export's ``w_int8_t``) or, without it,
    a k-contiguous copy of ``w_q``; x's grid, the output type and the
    per-channel scale pointer; one count per call; a ``w_t`` of the wrong
    shape and K % 16 raise before any launch."""
    x, layer = _k7_case(480, 384, True, F32, 3)
    tl = {key: torch.from_numpy(np.asarray(v)) for key, v in layer.items()}
    tl["w_int8_t"] = fs.pack_k_major(tl["w_int8"])
    xt = torch.from_numpy(x)
    kw = dict(x_scale=torch.tensor(IN_Q["scale"]), x_zero_point=torch.tensor(IN_Q["zero_point"]),
              w_scale=tl["w_scale"], w_colsum=tl["w_colsum"], bias=tl["bias"])
    before = pg.fused_quantize_matmul.launches
    y = pg.fused_quantize_matmul(xt, tl["w_int8"], **kw, w_t=tl["w_int8_t"])
    name, args = recorder.calls[-1]
    assert name == "qvt_quantize_gemm" and y.shape == (M, 384) and y.dtype == F32
    assert args[:6] == (xt.data_ptr(), tl["w_int8_t"].data_ptr(), tl["w_colsum"].data_ptr(),
                        tl["bias"].data_ptr(), tl["w_scale"].data_ptr(), y.data_ptr())
    assert args[6:12] == (M, 384, 480, 0, 0, 1)
    assert args[12:18] == (0.0, f32(IN_Q["scale"]), 100 - 128, fs.inv_scale(IN_Q["scale"]),
                           100.0, 255.0)
    y = qm.quantized_dense(xt.to(BF16), tl, {"scale": kw["x_scale"],
                                             "zero_point": kw["x_zero_point"]},
                           use_pallas=True, out_dtype=BF16)
    name, args = recorder.calls[-1]
    assert args[1] == tl["w_int8_t"].data_ptr() and args[9:11] == (1, 1) and y.dtype == BF16
    pg.fused_quantize_matmul(xt, tl["w_int8"], **kw)  # packed here
    name, args = recorder.calls[-1]
    assert args[1] not in (tl["w_int8_t"].data_ptr(), tl["w_int8"].data_ptr())
    assert pg.fused_quantize_matmul.launches == before + 3
    calls = len(recorder.calls)
    with pytest.raises(ValueError, match="w_t"):
        pg.fused_quantize_matmul(xt, tl["w_int8"], **kw, w_t=tl["w_int8"][:384])
    with pytest.raises(ValueError, match="unsupported K"):
        pg.fused_quantize_matmul(torch.zeros(4, 100), torch.zeros(100, 128, dtype=torch.int8),
                                 **{**kw, "w_colsum": torch.zeros(128, dtype=torch.int32),
                                    "w_scale": torch.tensor(0.002)})
    assert len(recorder.calls) == calls and pg.fused_quantize_matmul.launches == before + 3


def test_k7_packed_weight_checked(recorder):
    """A ``w_t`` that is not ``pack_k_major(w_q)`` raises before any launch;
    the right one launches, and a new ``w_q`` tensor with this ``w_t`` is
    compared again."""
    x, layer = _k7_case(384, 384, False, F32, 5)
    w_q = torch.from_numpy(layer["w_int8"])
    kw = dict(x_scale=torch.tensor(IN_Q["scale"]), x_zero_point=torch.tensor(IN_Q["zero_point"]),
              w_scale=torch.tensor(layer["w_scale"]),
              w_colsum=torch.from_numpy(layer["w_colsum"]), bias=torch.from_numpy(layer["bias"]))
    xt = torch.from_numpy(x)
    stale = fs.pack_k_major(w_q)
    stale[7, 11] += 1
    calls = len(recorder.calls)
    with pytest.raises(ValueError, match="pack_k_major"):
        pg.fused_quantize_matmul(xt, w_q, **kw, w_t=stale)
    assert len(recorder.calls) == calls
    w_t = fs.pack_k_major(w_q)
    for _ in range(2):
        pg.fused_quantize_matmul(xt, w_q, **kw, w_t=w_t)
    assert len(recorder.calls) == calls + 2 and recorder.calls[-1][1][1] == w_t.data_ptr()
    other = w_q.clone()
    other[0, 0] += 1
    with pytest.raises(ValueError, match="pack_k_major"):
        pg.fused_quantize_matmul(xt, other, **kw, w_t=w_t)
    assert len(recorder.calls) == calls + 2


def test_k5b_f32_launch_arguments(recorder):
    """The f32 K5b launches kernel B's rows then keys pass with K5b's
    arithmetic (``qvt_attention_long_bwd_rows`` / ``_keys``): the same
    qkv, do, one ``[3, B, H, N]`` f64 statistics scratch and dqkv, the
    shape, ``n_valid``, the f32 q scale and the f32 gradient scale; two
    counts per call; past its plan it raises before any launch."""
    b, n, h, hd = 2, 2305, 9, 64
    qkv, do = torch.zeros(b, n, 3 * h * hd), torch.zeros(b, n, h * hd)
    before = la.long_attention_bwd.launches
    dqkv = la.long_attention_bwd(qkv, do, h, hd, n_valid=2300)
    (rn, rargs), (kn, kargs) = recorder.calls[-2:]
    assert (rn, kn) == ("qvt_attention_long_bwd_rows", "qvt_attention_long_bwd_keys")
    assert rargs == kargs and dqkv.shape == qkv.shape and dqkv.dtype == F32
    assert rargs[:2] == (qkv.data_ptr(), do.data_ptr()) and rargs[3] == dqkv.data_ptr()
    scale = float(np.float32(hd ** -0.5))
    assert rargs[4:] == (b, n, h, hd, 2300, scale, scale, 0)
    assert la.long_attention_bwd.launches == before + 2
    calls = len(recorder.calls)
    with pytest.raises(ValueError, match="unsupported"):
        la.long_attention_bwd(torch.zeros(1, 18_473, 3 * 128), torch.zeros(1, 18_473, 128), 1, 128)
    assert len(recorder.calls) == calls and la.long_attention_bwd.launches == before + 2
