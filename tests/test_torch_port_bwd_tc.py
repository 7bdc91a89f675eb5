"""The numerics of kernel B in bf16 on the tensor cores, rehearsed on the CPU.

Kernel B (K1's backward, ``qvt_attention_bwd_mma`` in
``csrc/attention_bwd_mma.cu``) runs two passes on ``mma.sync``. The rows
pass takes each query row's running max m, sum l of exp2((s - m)·log2e)
and R of exp2(..)·dp online over 32-key tiles in f32, keeps lse2 = m·log2e
+ log2(l) and rowsum = R / l, then recomputes s and dp and sums
dq = bf16(p·(dp − rowsum))·k·scale with p = exp2(s·log2e − lse2); the keys
pass recomputes p and ds from those statistics and sums dv = bf16(p)ᵀ·do and
dk = dsᵀ·q·scale. s is the f32 score dot scaled after it, q unscaled, and
with ``in_fq`` q, k and v are fake-quantized as they are staged and the
straight-through mask of the raw qkv zeroes dqkv. It sums in the tensor
cores' order, so on the card it is held to ``long_attention.tc_errors``
(dq, dk, dv within rel L2 1e-2 of the plain version, at most twice the
plain version's rel L2 to the f64 math), two launches identical and the
STE zero set identical.

This file holds a Python model of that tile algorithm, in its tile order
and roundings (f32 statistics and accumulators, bf16 p and ds), to those
bounds against the index-order plain version (``attention_bwd_plain``) and
the f64 math (``long_attention_f64``, with ``in_fq`` its gradient at the
fake-quantized values times the mask), at N 1 to 512 (past the old
shared-memory plan), n_valid < N and hd 8 to 128, and against JAX's
``attention_train`` / ``attention_train_fq`` VJP in interpret mode; checks
the wrapper's launch arguments against a recording stand-in for the kernel
library; and holds both kernels' gates to every N that JAX's K1 gate
admits. Inputs are numpy, seeded, and go to both packages.
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
from qat_vit_tpu_torch.ops import long_attention as la
from qat_vit_tpu_torch.ops.flash_attention import split_heads
from qat_vit_tpu_torch.quant.fake_quant import ste_mask

BF16 = torch.bfloat16
LOG2E = np.float32(1.4426950408889634)
TILE = 32  # keys per tile of the rows pass (BN in csrc/attention_bwd_mma.cu)
FQ = (4.2 / 255, 127.0)  # a qkv grid whose ends clip ~3% of N(0, 1)
IN_FQ = (0, 255)


def _case(b, n, h, hd, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (b, n, 3 * h * hd)).astype(np.float32)
    do = rng.normal(0, 1, (b, n, h * hd)).astype(np.float32)
    return torch.from_numpy(qkv).to(BF16), torch.from_numpy(do).to(BF16)


def _packed(t):
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


def bwd_model(qkv, do, h, hd, qs=None, in_fq=None, n_valid=None):
    """Kernel B's tile algorithm → dqkv bf16 ``[B, N, 3·H·hd]``."""
    b, n, _ = qkv.shape
    n_valid = n if n_valid is None else n_valid
    q, k, v = (t.float() for t in split_heads(qkv, h, hd, qs, in_fq))
    g = do.float().reshape(b, n, h, hd).transpose(1, 2)
    scale = np.float32(hd ** -0.5)

    def tile(k0, k1):  # s (scaled after the dot, keys >= n_valid at -1e30) and dp
        s = (q @ k[:, :, k0:k1].transpose(-1, -2)) * scale
        s = s.masked_fill(torch.arange(k0, k1) >= n_valid, -1e30)
        return s, g @ v[:, :, k0:k1].transpose(-1, -2)

    # rows pass, sweep 1: the online statistics
    m = torch.full((b, h, n, 1), -1e30)
    l = torch.zeros((b, h, n, 1))
    r = torch.zeros((b, h, n, 1))
    for k0 in range(0, n, TILE):
        s, dp = tile(k0, min(n, k0 + TILE))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        e = torch.exp2(s * LOG2E - m_new * LOG2E)
        l = l * alpha + e.sum(dim=-1, keepdim=True)
        r = r * alpha + (e * dp).sum(dim=-1, keepdim=True)
        m = m_new
    lse2 = m * LOG2E + torch.log2(l)
    rowsum = r / l
    # sweep 2 and the keys pass: p and ds from the statistics, the products
    s, dp = tile(0, n)
    p = torch.exp2(s * LOG2E - lse2)
    ds = (p * (dp - rowsum)).to(BF16).float()
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    dv = p.to(BF16).float().transpose(-1, -2) @ g
    dqkv = torch.cat([_packed(t) for t in (dq, dk, dv)], dim=-1)
    if in_fq is not None:
        dqkv = dqkv * ste_mask(qkv, qs[0], qs[1], *in_fq)
    return dqkv.to(BF16)


def assert_tc_close(got, plain, ref):
    ok, errs = la.tc_errors(got, plain, ref, 3)
    assert ok, errs


# (b, n, heads, hd, n_valid): N 2 and 5, the micro ViT's 17, ViT-S's 197,
# ragged N with masked keys, hd 8, 32, 72 and 128, and N past the old
# shared-memory plan at 6 heads of 64 (400-512); N 1 (dq and dk exactly 0)
# in test_one_key
SHAPES = [(2, 2, 2, 64, 2), (3, 5, 2, 64, 4), (2, 17, 2, 64, 17), (1, 197, 6, 64, 197),
          (2, 33, 3, 8, 33), (2, 97, 2, 32, 90), (1, 130, 2, 72, 130), (1, 77, 2, 128, 70),
          (1, 400, 6, 64, 400), (1, 512, 6, 64, 500)]


@pytest.mark.parametrize("fq", [False, True])
@pytest.mark.parametrize("b,n,h,hd,n_valid", SHAPES)
def test_model_within_tolerance_of_plain(b, n, h, hd, n_valid, fq):
    """The model against ``attention_bwd_plain`` (index-order f32 sums, exp
    and the softmax sums in f64): dq, dk, dv within rel L2 1e-2 and at most
    twice the plain version's rel L2 to the f64 math of the same
    fake-quantized qkv; both zero exactly where the STE mask is off."""
    qkv, do = _case(b, n, h, hd, 3 * n + hd + b)
    kw = {"qs": torch.tensor(FQ), "in_fq": IN_FQ} if fq else {}
    got = bwd_model(qkv, do, h, hd, n_valid=n_valid, **kw)
    want = fat.attention_bwd_plain(qkv, do, h, hd, n_valid=n_valid, **kw)
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape
    ref = la.long_attention_f64(qkv, h, hd, do, n_valid=n_valid, **kw)[1]
    assert_tc_close(got, want, ref)
    if fq:
        off = ~ste_mask(qkv, *kw["qs"], *IN_FQ)
        assert off.any() and not got[off].any() and not want[off].any() and not ref[off].any()
    d = h * hd
    assert not got[:, n_valid:, d:].any()  # masked keys: no dk, dv


def test_one_key():
    """With one key (N 1, or n_valid 1) p is 1 on it and ds = p·(dp −
    rowsum) is exactly 0: the model and the plain version give dq = dk = 0
    and dv = do on the valid key, identically."""
    for n, n_valid in ((1, 1), (6, 1)):
        qkv, do = _case(2, n, 2, 64, n)
        got = bwd_model(qkv, do, 2, 64, n_valid=n_valid)
        want = fat.attention_bwd_plain(qkv, do, 2, 64, n_valid=n_valid)
        assert torch.equal(got, want) and not got[..., :256].any()
        assert torch.equal(got[:, 0, 256:], do.sum(1))


def test_online_statistics_match_the_softmax():
    """The rows pass's lse2 and rowsum, taken online over 32-key tiles,
    give p = exp2(s·log2e − lse2) and rowsum(dp·p) of the two-pass softmax
    within f32 rounding (N 197, three tiles past the first max)."""
    qkv, do = _case(1, 197, 2, 64, 7)
    q, k, v = (t.float() for t in split_heads(qkv, 2, 64))
    g = do.float().reshape(1, 197, 2, 64).transpose(1, 2)
    s = (q @ k.transpose(-1, -2)) * np.float32(64 ** -0.5)
    p = torch.softmax(s.double(), dim=-1)
    dp = (g @ v.transpose(-1, -2)).double()
    want = (p * dp).sum(-1, keepdim=True)
    m = torch.full((1, 2, 197, 1), -1e30)
    l, r = torch.zeros_like(m), torch.zeros_like(m)
    for k0 in range(0, 197, TILE):
        st, dpt = s[..., k0:k0 + TILE], dp[..., k0:k0 + TILE].float()
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        e = torch.exp2(st * LOG2E - m_new * LOG2E)
        l, r, m = l * alpha + e.sum(-1, keepdim=True), r * alpha + (e * dpt).sum(-1, True), m_new
    lse2 = m * LOG2E + torch.log2(l)
    assert torch.allclose(torch.exp2(s * LOG2E - lse2).double(), p, rtol=1e-5, atol=1e-7)
    assert torch.allclose((r / l).double(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fq", [False, True])
def test_model_matches_jax(fq):
    """The model against the VJP of JAX's ``attention_train`` /
    ``attention_train_fq`` in interpret mode at the micro ViT's 17 tokens
    and at 40 (N padded to 32 and 64 there, the padding masked): JAX's dqkv
    in the plain version's place, the same tolerance (dq, dk, dv within rel
    L2 1e-2, at most twice JAX's rel L2 to the f64 math); the STE zeroes
    the same elements."""
    h, hd = 2, 64
    for b, n in ((3, 17), (2, 40)):
        qkv, do = _case(b, n, h, hd, n + 1)
        jq = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16)
        jdo = jnp.asarray(do.float().numpy()).astype(jnp.bfloat16)
        if fq:
            def fn(x):
                return jax_attention_train_fq(x, jnp.asarray([FQ], jnp.float32), h, hd, *IN_FQ,
                                              4, True)
        else:
            def fn(x):
                return jax_attention_train(x, h, hd, 4, True)
        _, vjp = jax.vjp(fn, jq)
        jgrad = np.array(jnp.asarray(vjp(jdo)[0], jnp.float32))
        want = torch.from_numpy(jgrad).to(BF16)
        kw = {"qs": torch.tensor(FQ), "in_fq": IN_FQ} if fq else {}
        got = bwd_model(qkv, do, h, hd, **kw)
        assert_tc_close(got, want, la.long_attention_f64(qkv, h, hd, do, **kw)[1])
        if fq:
            assert torch.equal(want == 0, (want == 0) | ~ste_mask(qkv, *kw["qs"], *IN_FQ))
            assert not got[~ste_mask(qkv, *kw["qs"], *IN_FQ)].any()


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
    monkeypatch.setattr(fat, "use_plain", lambda t: False)
    monkeypatch.setattr(fat, "stream_of", lambda dev: 0)
    return rec


def test_launch_arguments(recorder):
    """What ``attention_bwd`` hands the kernels (CPU tensors, a recording
    library): bf16 goes to ``qvt_attention_bwd_mma`` with an f32
    ``[2, B, H, N]`` statistics scratch, the f32 scale hd^-0.5 and the
    fake-quant pointer, flag and range only with ``in_fq``, at any N (here
    past the old plan); f32 goes to the CUDA-core rows and keys passes
    (``qvt_attention_bwd_rows`` then ``qvt_attention_bwd_keys``, the same
    arguments, an f64 statistics scratch); one counted call each; an
    unsupported head dim or dtype, or an f32 N past the rows pass's plan,
    raises before any launch."""
    b, n, h, hd = 2, 600, 6, 64
    qkv, do = torch.zeros(b, n, 3 * h * hd, dtype=BF16), torch.zeros(b, n, h * hd, dtype=BF16)
    qs = torch.tensor(FQ)
    scale = float(np.float32(hd ** -0.5))
    before = fat.attention_bwd.launches
    out = fat.attention_bwd(qkv, do, h, hd, n_valid=590)
    name, args = recorder.calls[-1]
    assert name == "qvt_attention_bwd_mma" and out.dtype == BF16 and out.shape == qkv.shape
    assert args[:3] == (qkv.data_ptr(), do.data_ptr(), None) and args[4] == out.data_ptr()
    assert isinstance(args[3], int) and args[5:10] == (b, n, h, hd, 590)
    assert args[10:14] == (scale, 0, 0.0, 0.0)
    fat.attention_bwd(qkv, do, h, hd, qs=qs, in_fq=IN_FQ)
    name, args = recorder.calls[-1]
    assert name == "qvt_attention_bwd_mma" and args[2] == qs.data_ptr()
    assert args[5:10] == (b, n, h, hd, n) and args[10:14] == (scale, 1, 0.0, 255.0)
    x32, g32 = torch.zeros(1, 700, 3 * 128), torch.zeros(1, 700, 128)
    out = fat.attention_bwd(x32, g32, 1, 128, qs=qs, in_fq=IN_FQ)
    (rows, args), (keys, args2) = recorder.calls[-2:]
    assert (rows, keys) == ("qvt_attention_bwd_rows", "qvt_attention_bwd_keys")
    assert args == args2 and out.dtype == torch.float32
    assert args[:3] == (x32.data_ptr(), g32.data_ptr(), qs.data_ptr())
    assert isinstance(args[3], int) and args[4] == out.data_ptr()
    assert args[5:10] == (1, 700, 1, 128, 700)
    assert args[10:14] == (float(np.float32(128 ** -0.5)), 1, 0.0, 255.0)
    assert fat.attention_bwd.launches == before + 3
    calls = len(recorder.calls)
    with pytest.raises(ValueError, match="unsupported"):
        fat.attention_bwd(torch.zeros(1, 17, 3 * 60, dtype=BF16), torch.zeros(1, 17, 60,
                                                                               dtype=BF16), 1, 60)
    with pytest.raises(ValueError, match="unsupported"):  # past the f32 rows pass's plan
        fat.attention_bwd(torch.zeros(1, 18473, 3 * 128), torch.zeros(1, 18473, 128), 1, 128)
    with pytest.raises(ValueError, match="dtype"):
        fat.attention_bwd(qkv.half(), do.half(), h, hd)
    with pytest.raises(ValueError, match="qs: missing"):
        fat.attention_bwd(qkv, do, h, hd, in_fq=IN_FQ)
    assert len(recorder.calls) == calls and fat.attention_bwd.launches == before + 3


def test_kernels_take_every_n_the_jax_gate_admits():
    """Wherever the K1 gate (``attention_train_available``) is true, kernel
    A's and kernel B's own shape checks pass in both dtypes: the bf16
    kernels at any N, the f32 ones with a plan of R rows per block (the
    widest N, 1,248, at one head of 128, where kernel A takes 16 rows and
    kernel B's rows pass 8); the old resident plans stop well before."""
    widest = 0
    for hd in (8, 16, 32, 64, 128):
        for h in range(1, 17):
            for n in (1, 17, 197, 203, 204, 376, 420, 421, 512, 513, 608, 864, 1248, 1249):
                for dt in (BF16, torch.float32):
                    if fat.attention_train_available(h, hd, n, dt):
                        widest = max(widest, n)
                        assert fa.attention_fwd_shapes_ok(n, hd, dt), (h, hd, n, dt)
                        assert fat.attention_bwd_shapes_ok(n, hd, dt), (h, hd, n, dt)
    assert widest == 1248 and fat.attention_train_available(1, 128, 1248, torch.float32)
    assert fa.attention_smem_bytes(1248, 128, torch.float32) > 232_448
    assert fa.attention_f32_rows(1248, 128) == 16 and fa.attention_f32_rows(1248, 128, True) == 8
    assert fa.attention_f32_smem_bytes(1248, 128, 8, backward=True) <= 232_448
    assert fa.attention_f32_smem_bytes(1248, 128, 16) <= 232_448
    assert fat.attention_bwd_keys_smem_bytes(128) <= 232_448
