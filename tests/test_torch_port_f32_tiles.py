"""The f32 kernels A and B on the CUDA cores (``csrc/attention_f32.cu``),
rehearsed on the CPU.

Kernel A runs one block per (R queries, head, image): it stages K in
128-key tiles, writes the scores into an [R, ~N] strip, takes the max, the
f64 sum and p row by row, then stages V in 128-key tiles for o = p·v.
Kernel B runs two launches: a rows pass per (R query rows, head, image)
that writes s and dp of 64-key tiles into two strips, forms the row
statistics (max, f64 sum, rowsum(dp·p)) and ds, keeps the statistics in an
f64 ``[3, B, H, N]`` scratch and sums dq over 128-key tiles of K; then a
keys pass per (32 keys, head, image) that streams q, do and the statistics
in 64-query tiles and sums dk and dv. Every dot accumulates from +0 in
index order, zero rows and columns padded onto a dot add +0, and the f64
row sums run in the warp's order (lane-strided partial sums, then an xor
butterfly), so the kernels give the plain versions' bits.

This file holds a Python model of those tilings, in that order, identical
to ``attention_fwd_plain`` / ``attention_bwd_plain`` at odd N, n_valid < N,
N not a multiple of R or of the 32 keys, hd 8 / 64 / 128, R at 1, 16 and
32, and ``in_fq`` with its STE zero set; the same model against JAX's
``attention_train`` / ``attention_train_fq`` in interpret mode; the
shared-memory plans against the card's limit wherever the f32 gates take
a shape, and the gates against the N ranges the previous kernels took; and
the wrappers' launches against a recording stand-in for the kernel library.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qat_vit_tpu.ops.flash_attention_train import attention_train as jax_attention_train
from qat_vit_tpu.ops.flash_attention_train import attention_train_fq as jax_attention_train_fq
from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops import flash_attention as fa
from qat_vit_tpu_torch.ops import flash_attention_train as fat
from qat_vit_tpu_torch.ops._cuda import SMEM_LIMIT, bwd_scale_f32
from qat_vit_tpu_torch.ops.flash_attention import split_heads
from qat_vit_tpu_torch.quant.fake_quant import ste_mask


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32 = torch.float32
IN_FQ = (0, 255)
FQ = (4.2 / 255, 127.0)  # clips ~3% of N(0, 1)
# the JAX comparison's fake-quant: a power-of-two scale, as
# tests/test_torch_port_kernel_forms.py (XLA on the CPU fuses fq's divide and add)
JAX_FQ = (2.0 ** -6, 127.0)
KT, KEYS, QT = fa._F32_KT, fat._F32_KEYS, fat._F32_QT


def _case(b, n, h, hd, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (b, n, 3 * h * hd)).astype(np.float32)
    do = rng.normal(0, 1, (b, n, h * hd)).astype(np.float32)
    return qkv, do


def _pad(x, rows):
    """x [..., r, hd] with zero rows up to ``rows``."""
    return torch.cat([x, x.new_zeros(x.shape[:-2] + (rows - x.shape[-2], x.shape[-1]))], -2)


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


def _warp_sum(x):
    """The f64 sum of x [..., n] over its last dim in a warp's order: lane L
    adds x[L], x[L + 32], .. from +0, then xor butterfly over 16, 8, .., 1."""
    n32 = -(-x.shape[-1] // 32) * 32
    xp = torch.cat([x, x.new_zeros(x.shape[:-1] + (n32 - x.shape[-1],))], -1)
    part = torch.zeros(x.shape[:-1] + (32,), dtype=torch.float64)
    for t in range(0, n32, 32):
        part = part + xp[..., t:t + 32]
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        part = part + part[..., lane ^ o]
    return part[..., :1]


def _softmax_rows(s):
    """(e, l, p) of a row block [..., n]: e = f32(exp(f64(s − max))), l its
    f64 sum, p = f32(f64(e) / l)."""
    e = torch.exp((s - s.amax(-1, keepdim=True)).double()).float()
    l = _warp_sum(e.double())
    return e, l, (e.double() / l).float()


def model_fwd(qkv, h, hd, qs=None, in_fq=None, n_valid=None, rows=None):
    """Kernel A's tiling → [B, N, H·hd] f32."""
    b, n, _ = qkv.shape
    nv = n if n_valid is None else n_valid
    rows = rows or fa.attention_f32_rows(n, hd)
    q, k, v = split_heads(qkv, h, hd, qs, in_fq)
    q = q * torch.tensor(hd ** -0.5, dtype=F32)
    n4, tile = -(-n // 4) * 4, 2 * KT
    out = torch.empty(b, h, n, hd)
    for i0 in range(0, n, rows):
        rws = min(rows, n - i0)
        strip = torch.zeros(b, h, rws, n4)
        for k0 in range(0, n, tile):
            cols = min(tile, n - k0)
            s = _dot_d(q[:, :, i0:i0 + rws], _pad(k[:, :, k0:k0 + cols], tile))
            s = s.masked_fill(torch.arange(k0, k0 + tile) >= nv, -1e30)
            strip[..., k0:k0 + cols] = s[..., :cols]
        strip[..., :n] = _softmax_rows(strip[..., :n])[2]
        acc = torch.zeros(b, h, rws, hd)
        for k0 in range(0, n, tile):
            vt = _pad(v[:, :, k0:k0 + min(tile, n - k0)], tile)
            acc = _g2(acc, strip[..., k0:], vt, min(tile, n4 - k0))
        out[:, :, i0:i0 + rws] = acc
    return out.transpose(1, 2).reshape(b, n, h * hd)


def model_bwd(qkv, do, h, hd, qs=None, in_fq=None, n_valid=None, rows=None):
    """Kernel B's two passes → (dqkv [B, N, 3·H·hd] f32, the rows pass's
    statistics [3, B, H, N] f64)."""
    b, n, _ = qkv.shape
    nv = n if n_valid is None else n_valid
    rows = rows or fa.attention_f32_rows(n, hd, backward=True)
    q, k, v = split_heads(qkv, h, hd, qs, in_fq)
    g = do.reshape(b, n, h, hd).transpose(1, 2)
    scale = bwd_scale_f32(hd, "cpu")
    n4 = -(-n // 4) * 4
    stats = torch.empty(3, b, h, n, dtype=torch.float64)
    dq, dk, dv = (torch.empty(b, h, n, hd) for _ in range(3))
    for i0 in range(0, n, rows):  # the rows pass
        rws = min(rows, n - i0)
        ss, ds = torch.zeros(b, h, rws, n4), torch.zeros(b, h, rws, n4)
        for k0 in range(0, n, KT):
            cols = min(KT, n - k0)
            s = _dot_d(q[:, :, i0:i0 + rws], _pad(k[:, :, k0:k0 + cols], KT)) * scale
            s = s.masked_fill(torch.arange(k0, k0 + KT) >= nv, -1e30)
            dp = _dot_d(g[:, :, i0:i0 + rws], _pad(v[:, :, k0:k0 + cols], KT))
            ss[..., k0:k0 + cols], ds[..., k0:k0 + cols] = s[..., :cols], dp[..., :cols]
        x, dp = ss[..., :n], ds[..., :n]
        _, l, p = _softmax_rows(x)
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
            qt, gt = (_pad(t[:, :, q0:q0 + nq], QT) for t in (q, g))
            st = (_dot_d(kc, qt) * scale).masked_fill(
                (torch.arange(j0, j0 + KEYS) >= nv)[:, None], -1e30)
            dpt = _dot_d(vc, gt)
            mq, lq, rq = (torch.cat([t[..., q0:q0 + nq], t.new_ones(b, h, QT - nq)], -1)
                          .unsqueeze(-2) for t in (m, l, r))
            e = torch.exp((st - mq).double()).float()
            p = (e.double() / lq).float()
            dst = p * (dpt - rq)
            live = torch.arange(QT) < nq  # the columns past N: +0
            p, dst = (torch.where(live, t, torch.zeros_like(t)) for t in (p, dst))
            ak = _g2(ak, dst, qt, -(-nq // 4) * 4)
            av = _g2(av, p, gt, -(-nq // 4) * 4)
        dk[:, :, j0:j0 + keys] = (ak * scale)[:, :, :keys]
        dv[:, :, j0:j0 + keys] = av[:, :, :keys]
    dqkv = torch.cat([t.transpose(1, 2).reshape(b, n, h * hd) for t in (dq, dk, dv)], -1)
    if in_fq is not None:
        dqkv = torch.where(ste_mask(qkv, qs[0], qs[1], *in_fq), dqkv, torch.zeros_like(dqkv))
    return dqkv, stats


@pytest.mark.parametrize("fq", [False, True])
@pytest.mark.parametrize("b,n,h,hd,n_valid,rows", [
    (2, 37, 2, 8, 37, None), (2, 37, 2, 8, 30, 16), (1, 37, 2, 8, 37, 1),
    (1, 150, 2, 8, 140, None), (1, 33, 1, 64, 33, None), (1, 20, 1, 128, 17, None)])
def test_tile_model_identical_to_plain(b, n, h, hd, n_valid, rows, fq):
    """The model of both kernels gives the plain versions' bits: several
    row blocks (R 32, 16 and 1) and key blocks of 32, ragged last tiles of
    128, 64 and 32 keys or queries, masked keys, hd 8 / 64 / 128; with
    ``in_fq`` the STE zero set is the plain version's and not empty."""
    qkv, do = (torch.from_numpy(t) for t in _case(b, n, h, hd, n + hd))
    kw = {"qs": torch.tensor(FQ), "in_fq": IN_FQ} if fq else {}
    want = fa.attention_fwd_plain(qkv, h, hd, n_valid=n_valid, **kw)
    assert torch.equal(model_fwd(qkv, h, hd, n_valid=n_valid, rows=rows, **kw), want)
    grad, stats = model_bwd(qkv, do, h, hd, n_valid=n_valid, rows=rows, **kw)
    want = fat.attention_bwd_plain(qkv, do, h, hd, n_valid=n_valid, **kw)
    assert torch.equal(grad, want)
    assert stats.dtype == torch.float64 and stats.shape == (3, b, h, n)
    if fq:
        clipped = ~ste_mask(qkv, *kw["qs"], *IN_FQ)
        assert clipped.any() and not grad[clipped].any()


@pytest.mark.parametrize("fq", [False, True])
def test_tile_model_matches_jax(fq):
    """The model against JAX's kernels A and B in interpret mode at 2 heads
    of 64 and 20 tokens: forward to 1e-5, dqkv to 2e-4, the bounds of
    ``test_attention_train_f32_forms_match_jax``; the same STE zeros."""
    h, hd, n = 2, 64, 20
    qkv, do = _case(2, n, h, hd, 20)
    if fq:
        def jax_fn(x):
            return jax_attention_train_fq(x, jnp.asarray([JAX_FQ], jnp.float32), h, hd, *IN_FQ,
                                          4, True)
    else:
        def jax_fn(x):
            return jax_attention_train(x, h, hd, 4, True)
    jout, jgrad = jax.jit(lambda x: (jax_fn(x), jax.vjp(jax_fn, x)[1](jnp.asarray(do))[0]))(
        jnp.asarray(qkv))
    jgrad = np.asarray(jgrad)
    kw = {"qs": torch.tensor(JAX_FQ), "in_fq": IN_FQ} if fq else {}
    x, g = torch.from_numpy(qkv), torch.from_numpy(do)
    np.testing.assert_allclose(model_fwd(x, h, hd, **kw).numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    grad = model_bwd(x, g, h, hd, **kw)[0].numpy()
    np.testing.assert_allclose(grad, jgrad, rtol=2e-4, atol=2e-4)
    if fq:
        assert (grad == 0).mean() > 0.01 and ((grad == 0) == (jgrad == 0)).all()


def _old_f32_gates(n, hd):
    """The f32 gates of the previous CUDA-core kernels: kernel A's resident
    or streamed tile, kernel B's streamed plan (its resident plan is
    smaller)."""
    fwd = min(4 * (n * (hd + 1) + n * hd + 8 * n + 8 * hd),
              4 * (32 * (hd + 1) + 8 * n + 8 * hd)) <= SMEM_LIMIT
    bwd = 2 * 32 * 4 * (hd + 1) + 16 * n + 8 * (8 * n + 8 * hd) <= SMEM_LIMIT
    return fwd, bwd


def test_plans_fit_and_gates_cover_the_old_range():
    """Wherever the f32 gates take (n, hd), the picked plan fits in 232,448
    bytes and twice its rows would not (up to 32); the keys pass fits at
    every hd; the gates take every (n, hd) the previous kernels took
    (kernel A to n 6,620 and kernel B to 2,390 at hd 128), and more."""
    for hd in range(8, 129, 8):
        assert fat.attention_bwd_keys_smem_bytes(hd) <= SMEM_LIMIT
        for n in (*range(1, 70), 197, 203, 204, 512, 1248, 2390, 2391, 2647, 6620, 6939,
                  7219, 18000, 18472, 18473, 39080, 39081, 60000):
            old_fwd, old_bwd = _old_f32_gates(n, hd)
            for backward, ok, old in ((False, fa.attention_fwd_shapes_ok(n, hd, F32), old_fwd),
                                      (True, fat.attention_bwd_shapes_ok(n, hd, F32), old_bwd)):
                rows = fa.attention_f32_rows(n, hd, backward)
                assert ok == (rows > 0) and (ok or not old), (n, hd, backward)
                if ok:
                    assert fa.attention_f32_smem_bytes(n, hd, rows, backward) <= SMEM_LIMIT
                    assert rows == 32 or (fa.attention_f32_smem_bytes(n, hd, 2 * rows, backward)
                                          > SMEM_LIMIT)
    assert fa.attention_f32_rows(197, 64, True) == fa.attention_f32_rows(197, 64) == 32
    assert fa.attention_f32_rows(512, 128, True) == 16
    assert fat.attention_bwd_shapes_ok(18472, 128, F32)
    assert not fat.attention_bwd_shapes_ok(18473, 128, F32)
    assert fa.attention_fwd_shapes_ok(39080, 128, F32)
    assert not fa.attention_fwd_shapes_ok(39081, 128, F32)


class _Recorder:
    """A stand-in kernel library: records each entry point's arguments."""

    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        assert len(args) == len(_build._SIGNATURES[name]), (name, len(args))
        self.calls.append((name, args))


def test_launch_arguments(monkeypatch):
    """An f32 kernel-B call (CPU tensors, a recording library) launches the
    rows pass then the keys pass with the same arguments: qkv, do, the
    fake-quant pointer, an f64 [3, B, H, N] scratch, dqkv, the shape, the
    f32 scale and the fake-quant flag and range; one counted call. A qkv or
    do that is not 16-byte aligned raises before any launch."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "load", lambda: rec)
    for mod in (fa, fat):
        monkeypatch.setattr(mod, "use_plain", lambda t: False)
        monkeypatch.setattr(mod, "stream_of", lambda dev: 0)
    made = []
    empty = torch.empty

    def spy(*args, **kwargs):
        t = empty(*args, **kwargs)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", spy)
    b, n, h, hd = 2, 150, 3, 64
    qkv, do = torch.zeros(b, n, 3 * h * hd), torch.zeros(b, n, h * hd)
    qs = torch.tensor(FQ)
    before = fat.attention_bwd.launches
    out = fat.attention_bwd(qkv, do, h, hd, qs=qs, in_fq=IN_FQ, n_valid=140)
    (name1, args1), (name2, args2) = rec.calls
    assert (name1, name2) == ("qvt_attention_bwd_rows", "qvt_attention_bwd_keys")
    assert args1 == args2 and fat.attention_bwd.launches == before + 1
    stats = [t for t in made if t.dtype == torch.float64]
    assert len(stats) == 1 and stats[0].shape == (3, b, h, n)
    assert args1[:5] == (qkv.data_ptr(), do.data_ptr(), qs.data_ptr(), stats[0].data_ptr(),
                         out.data_ptr())
    assert args1[5:10] == (b, n, h, hd, 140)
    assert args1[10:14] == (float(np.float32(hd ** -0.5)), 1, 0.0, 255.0)
    fat.attention_bwd(qkv, do, h, hd)
    assert rec.calls[-1][1][2] is None and rec.calls[-1][1][11:14] == (0, 0.0, 0.0)
    calls = len(rec.calls)
    skew = torch.zeros(b * n * 3 * h * hd + 1)[1:].view(b, n, 3 * h * hd)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fat.attention_bwd(skew, do, h, hd)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fat.attention_bwd(qkv, torch.zeros(b * n * h * hd + 1)[1:].view(b, n, h * hd), h, hd)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.attention_fwd(skew, h, hd)
    assert len(rec.calls) == calls and fat.attention_bwd.launches == before + 2
