"""The numerics of the bf16 long attention pair on the tensor cores, rehearsed on the CPU.

K5a (``csrc/attention_long_mma.cu``) and K5b (``csrc/attention_long_bwd_mma.cu``)
sum on the tensor cores in their own order, so on the card they are held to a
tolerance, not to identity (``long_attention.tc_errors``, which
``chip_smoke.compare_tc`` and the card tests apply). This file holds a
Python model of their tile algorithm to those bounds, so that the
formulation and the bounds are tested on measured numbers before any card
runs them:

- forward: q scaled by hd^-0.5 in bf16, 64-key tiles, an online softmax (the
  running max and sum in f32, exp2 of log2e-scaled scores), the unnormalised
  p rounded to bf16 for p·v, one division at the end, and the log-sum-exp;
  a two-pass form that rounds the normalised p, as the plain version does,
  is modelled beside it, to measure what the online form gives up;
- backward: p = exp(s - lse) from the forward's statistics, D = rowsum(do ∘ o)
  from its bf16 output, ds = p (dp - D) and p rounded to bf16, dq and dk
  scaled in f32 after their dots (dk with the unscaled q).

The model is held against the plain versions (``long_attention_qkv_plain``,
``long_attention_bwd_plain``) and against JAX's ``long_attention_qkv`` /
``long_attention_train`` in interpret mode, and its error to the f64 math
(``long_attention_f64``) against theirs, on ragged N, n_valid < N and hd 72
and 128. Also on the CPU: ``tc_errors`` on planted faults, the split gates,
the preset's routing, and the wrappers' launch arguments against a recording stand-in for the kernel
library. Inputs are numpy, seeded, and go to both packages.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qat_vit_tpu.models.vit import ViTConfig as JaxViTConfig
from qat_vit_tpu.ops.long_attention import long_attention_qkv as jax_long_attention_qkv
from qat_vit_tpu.ops.long_attention import long_attention_shapes_ok as jax_long_shapes_ok
from qat_vit_tpu.ops.long_attention import long_attention_train as jax_long_attention_train
from qat_vit_tpu.serve.int8_vit import _preset_kernel_opts as jax_preset_kernel_opts
from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.models.vit import ViTConfig
from qat_vit_tpu_torch.ops import long_attention as la
from qat_vit_tpu_torch.ops.flash_attention import _q_scale, split_heads
from qat_vit_tpu_torch.serve.int8_vit import _preset_kernel_opts

BF16 = torch.bfloat16
LOG2E = np.float32(1.4426950408889634)
TILE = 64  # keys per tile of the forward, query and key rows per block


def assert_tc_close(got, plain, ref, sections):
    """``got`` within the bf16 pair's tolerance (``long_attention.tc_errors``)."""
    ok, errs = la.tc_errors(got, plain, ref, sections)
    assert ok, errs


def _qkv_do(b, n, h, hd, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (b, n, 3 * h * hd)).astype(np.float32)
    do = rng.normal(0, 1, (b, n, h * hd)).astype(np.float32)
    return torch.from_numpy(qkv).to(BF16), torch.from_numpy(do).to(BF16)


def _heads(qkv, h, hd):
    """(q scaled in bf16, q, k, v) as f32 ``[B, H, N, hd]``."""
    q, k, v = (t.float() for t in split_heads(qkv, h, hd))
    qs = (q * float(_q_scale(hd, BF16))).to(BF16).float()
    return qs, q, k, v


def _packed(t):
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


def _scores(qkv, h, hd, n_valid, k0, k1):
    """(q scaled in bf16) · kᵀ over keys [k0, k1), keys >= n_valid at -1e30."""
    qs, _, k, _ = _heads(qkv, h, hd)
    s = qs @ k[:, :, k0:k1].transpose(-1, -2)
    return s.masked_fill(torch.arange(k0, k1) >= n_valid, -1e30)


def tc_forward(qkv, h, hd, n_valid=None, tile=TILE):
    """The forward's tile algorithm → (out bf16 ``[B, N, H·hd]``, lse f32
    ``[B, H, N]``): one pass over ``tile`` keys at a time, the running max m
    and sum l in f32, the unnormalised exp(s - m) rounded to bf16 for p·v,
    the sums rescaled as m grows, one division at the end."""
    b, n, _ = qkv.shape
    n_valid = n if n_valid is None else n_valid
    _, _, _, v = _heads(qkv, h, hd)
    m = torch.full((b, h, n, 1), -1e30)
    l = torch.zeros((b, h, n, 1))
    acc = torch.zeros((b, h, n, hd))
    for k0 in range(0, n, tile):
        k1 = min(n, k0 + tile)
        s = _scores(qkv, h, hd, n_valid, k0, k1)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((s - m_new) * LOG2E)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(BF16).float() @ v[:, :, k0:k1]
        m = m_new
    return _packed((acc / l).to(BF16)), (m + torch.log(l))[..., 0]


def two_pass_forward(qkv, h, hd, n_valid=None, tile=TILE):
    """The two-pass form, measured beside the online one: each row's max and
    sum first, then the normalised p = exp(s - m) / l rounded to bf16, as
    the plain version and JAX round it."""
    b, n, _ = qkv.shape
    n_valid = n if n_valid is None else n_valid
    _, _, _, v = _heads(qkv, h, hd)
    m = torch.full((b, h, n, 1), -1e30)
    l = torch.zeros((b, h, n, 1))
    for k0 in range(0, n, tile):
        s = _scores(qkv, h, hd, n_valid, k0, min(n, k0 + tile))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        l = l * torch.exp2((m - m_new) * LOG2E) + torch.exp2((s - m_new) * LOG2E).sum(
            dim=-1, keepdim=True)
        m = m_new
    acc = torch.zeros((b, h, n, hd))
    for k0 in range(0, n, tile):
        k1 = min(n, k0 + tile)
        p = torch.exp2((_scores(qkv, h, hd, n_valid, k0, k1) - m) * LOG2E) * (1 / l)
        acc = acc + p.to(BF16).float() @ v[:, :, k0:k1]
    return _packed(acc.to(BF16))


def tc_backward(qkv, do, h, hd, out, lse, n_valid=None):
    """The backward's algorithm from the forward's ``out`` and ``lse`` →
    dqkv bf16 ``[B, N, 3·H·hd]``."""
    b, n, _ = qkv.shape
    n_valid = n if n_valid is None else n_valid
    qs, q, k, v = _heads(qkv, h, hd)
    padded = torch.arange(n) >= n_valid
    g = do.float().reshape(b, n, h, hd).transpose(1, 2).masked_fill(padded[:, None], 0)
    o = out.float().reshape(b, n, h, hd).transpose(1, 2)
    dsum = (g * o).sum(dim=-1, keepdim=True)
    s = qs @ k.transpose(-1, -2)
    p = torch.exp2(s * LOG2E - lse[..., None] * LOG2E).masked_fill(padded, 0)
    p = p.masked_fill(padded[:, None], 0)
    ds = (p * (g @ v.transpose(-1, -2) - dsum)).to(BF16).float()
    scale = np.float32(hd ** -0.5)
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    dv = p.to(BF16).float().transpose(-1, -2) @ g
    return torch.cat([_packed(t.to(BF16)) for t in (dq, dk, dv)], dim=-1)


# ragged N (not a multiple of 64), n_valid < N, hd 72 (the dot padded to 80)
# and hd 128
SHAPES = [(2, 300, 2, 64, 300), (1, 257, 2, 72, 250), (1, 200, 1, 128, 190),
          (2, 130, 3, 32, 97)]


@pytest.mark.parametrize("b,n,h,hd,n_valid", SHAPES)
def test_tile_model_within_bounds_of_plain(b, n, h, hd, n_valid):
    """The model against the plain versions: the forward within 2^-7 (1 +
    |plain|) everywhere, dq, dk and dv within rel L2 1e-2, and every
    section's error to the f64 math at most twice the plain version's
    (measured here ~1.0x); padded rows zero."""
    qkv, do = _qkv_do(b, n, h, hd, n + hd)
    out, lse = tc_forward(qkv, h, hd, n_valid)
    ref_out, ref_grad = la.long_attention_f64(qkv, h, hd, do, n_valid=n_valid)
    assert_tc_close(out, la.long_attention_qkv_plain(qkv, h, hd, n_valid=n_valid), ref_out, 1)
    grad = tc_backward(qkv, do, h, hd, out, lse, n_valid)
    assert_tc_close(grad, la.long_attention_bwd_plain(qkv, do, h, hd, n_valid=n_valid),
                    ref_grad, 3)
    assert not grad[:, n_valid:].any() and grad[:, :n_valid].any()


def test_what_the_online_form_gives_up():
    """What rounding the unnormalised exp(s - m) costs: the one-pass form
    lands ~3e-3 (rel L2) from the plain version, as far as the bf16
    rounding of the output itself, where the two-pass form that rounds the
    normalised p, as the plain version and JAX do, stays within ~2e-4; both
    are as close to the f64 math as the plain version (the online form's
    ratio ~0.96 on the card)."""
    qkv, _ = _qkv_do(2, 300, 2, 64, 11)
    plain = la.long_attention_qkv_plain(qkv, 2, 64)
    ref = la.long_attention_f64(qkv, 2, 64)[0]
    one_pass, two_pass = tc_forward(qkv, 2, 64)[0], two_pass_forward(qkv, 2, 64)
    assert la.rel_l2(two_pass, plain) < 5e-4 < 1e-3 < la.rel_l2(one_pass, plain) < 1e-2
    assert_tc_close(one_pass, plain, ref, 1)
    assert_tc_close(two_pass, plain, ref, 1)


def test_lse_is_the_row_statistic():
    """The forward's log-sum-exp is the f64 one of the bf16-scaled scores
    within f32 rounding, and one tile or many give the same output within
    one bf16 step."""
    b, n, h, hd = 1, 200, 2, 64
    qkv, _ = _qkv_do(b, n, h, hd, 3)
    out, lse = tc_forward(qkv, h, hd)
    qs, _, k, _ = _heads(qkv, h, hd)
    want = torch.logsumexp((qs.double() @ k.double().transpose(-1, -2)), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-6, atol=1e-5)
    whole, _ = tc_forward(qkv, h, hd, tile=n)
    assert (out.float() - whole.float()).abs().max() <= 2 ** -8 * whole.float().abs().max()


@pytest.mark.parametrize("n,h,hd", [(150, 2, 72), (140, 1, 128)])
def test_tile_model_within_bounds_of_jax(n, h, hd):
    """The model against JAX's Pallas pair in interpret mode (N padded to
    its q tile of 128, the padding masked): the same bounds, with JAX's
    output in the plain version's place."""
    qkv, do = _qkv_do(1, n, h, hd, n * hd)
    jq = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16)
    g = jnp.asarray(do.float().numpy())
    jout = jax_long_attention_qkv(jq, h, hd, 128, True)
    jgrad = jax.grad(lambda x: (jax_long_attention_train(x, h, hd, 128, True)
                                .astype(jnp.float32) * g).sum())(jq)
    f = lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(BF16)  # noqa: E731
    out, lse = tc_forward(qkv, h, hd)
    ref_out, ref_grad = la.long_attention_f64(qkv, h, hd, do)
    assert_tc_close(out, f(jout), ref_out, 1)
    assert_tc_close(tc_backward(qkv, do, h, hd, out, lse), f(jgrad), ref_grad, 3)


@pytest.mark.parametrize("fault,sections,ok", [
    ("none", 1, True), ("none", 3, True),
    ("one element two bf16 steps off", 1, False),  # the forward's element bound
    ("one element two bf16 steps off", 3, True),  # the backward holds rel L2 only
    ("a section 2% off", 3, False),
    ("nan", 1, False), ("nan", 3, False),
    ("within 1e-2 of plain, 3x its distance to f64", 3, False),
])
def test_tc_errors_is_the_pair_tolerance(fault, sections, ok):
    """The bf16 pair's one tolerance (``tc_errors``, which the card checks
    apply): the element bound on the forward, rel L2 per backward section,
    finite values, and the f64 ratio."""
    rng = np.random.default_rng(5)
    ref = torch.from_numpy(rng.normal(0, 1, (2, 40, 3 * 16)))
    plain = (ref + torch.from_numpy(rng.normal(0, 1e-3, ref.shape))).to(BF16)
    got = plain.clone()
    if fault.startswith("one element"):
        got[1, 7, 3] = plain[1, 7, 3].float() + 2 * 2 ** -7 * (1 + plain[1, 7, 3].float().abs())
    elif fault.startswith("a section"):
        got[..., 16:32] = (plain[..., 16:32].float() * 1.02).to(BF16)
    elif fault == "nan":
        got[0, 0, 40] = float("nan")
    elif fault.startswith("within"):
        got = (ref + torch.from_numpy(rng.normal(0, 6e-3, ref.shape))).to(BF16)
        assert all(e["rel"] <= la.TC_REL_L2 for e in la.tc_errors(got, plain, ref, 3)[1])
    assert la.tc_errors(got, plain, ref, sections)[0] == ok
    if sections == 3:
        assert [e["label"] for e in la.tc_errors(got, plain, ref, 3)[1]] == ["dq", "dk", "dv"]
    with pytest.raises(ValueError):
        la.tc_errors(got.float(), plain, ref, sections)


def test_split_gates():
    """The bf16 pair's gate is JAX's ``long_attention_shapes_ok`` at any N;
    the f32 forms and K6 keep the shared-memory plans; the training pair's
    gate keeps JAX's N cap (4,096), so it routes as before."""
    for hd in (8, 16, 60, 64, 72, 128, 136, 256):
        for n in (1, 2305, 6048, 6049, 7000, 100_000):
            assert la.long_attention_stream_ok(n, hd) == jax_long_shapes_ok(9, hd), (n, hd)
    assert not la.long_attention_stream_ok(0, 64)
    assert la.long_attention_shapes_ok(6048, 64) and not la.long_attention_shapes_ok(6049, 64)
    assert not la.long_attention_shapes_ok(7000, 64, torch.float32)
    assert (la.long_attention_bwd_shapes_ok(5024, 128, torch.float32)
            and not la.long_attention_bwd_shapes_ok(5025, 128, torch.float32))
    for dt in (BF16, torch.float32):
        assert la.long_attention_train_available(9, 64, 4096, dt)
        assert not la.long_attention_train_available(9, 64, 4097, dt)
        assert not la.long_attention_train_available(1, 64, 7000, dt)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_preset_routes_as_before_at_1600px(act):
    """The preset's long rungs keep the plan gate: OWLv2-pruned widths at
    960 px (3,601 tokens) take the K6 chain; at 1,600 px (10,001 tokens)
    the preset raises where JAX serves a kernel (its rung 3 has no N cap),
    instead of sending the streaming K5a's rung 4 a chain JAX does not
    run."""
    for heads, hd in ((9, 64), (12, 64), (2, 128)):
        geo = dict(embed_dim=heads * hd, num_heads=heads, image_size=1600, patch_size=16, act=act)
        assert jax_preset_kernel_opts(JaxViTConfig(**geo)) != {}
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _preset_kernel_opts(ViTConfig(**geo))
    geo = dict(embed_dim=576, num_heads=9, image_size=960, patch_size=16, act=act)
    assert _preset_kernel_opts(ViTConfig(**geo)) == {"fused": "megamodel_long"}


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
    monkeypatch.setattr(la, "use_plain", lambda t: False)
    monkeypatch.setattr(la, "stream_of", lambda dev: 0)
    return rec


def test_launch_arguments(recorder):
    """What the wrappers hand the kernels (CPU tensors, a recording
    library): bf16 goes to the tensor-core entry points with the bf16 q
    scale, a log-sum-exp pointer only for training, the backward runs the
    forward first unless given ``out`` and ``lse``; f32 goes to the
    shared-memory forms; every argument list matches its C signature."""
    b, n, h, hd = 2, 7000, 1, 72
    qkv, do = _qkv_do(b, n, h, hd, 1)
    f0, b0 = la.long_attention_qkv.launches, la.long_attention_bwd.launches
    la.long_attention_qkv(qkv, h, hd, n_valid=6990)
    name, args = recorder.calls[-1]
    assert name == "qvt_attention_long_mma" and args[2] is None
    assert args[3:8] == (b, n, h, hd, 6990) and args[8] == float(torch.tensor(hd ** -0.5, dtype=BF16))
    la.long_attention_bwd(qkv, do, h, hd)
    (fname, fargs), (bname, bargs) = recorder.calls[-2:]
    assert fname == "qvt_attention_long_mma" and fargs[2] is not None
    assert bname == "qvt_attention_long_bwd_mma" and bargs[3] == fargs[2]  # the forward's lse
    assert bargs[1] == fargs[1] and bargs[7:12] == (b, n, h, hd, n)
    assert bargs[12] == fargs[8] and bargs[13] == float(np.float32(hd ** -0.5))
    out, lse = torch.zeros(b, n, h * hd, dtype=BF16), torch.zeros(b, h, n)
    calls = len(recorder.calls)
    la.long_attention_bwd(qkv, do, h, hd, out=out, lse=lse)
    assert [c[0] for c in recorder.calls[calls:]] == ["qvt_attention_long_bwd_mma"]
    assert recorder.calls[-1][1][1] == out.data_ptr() and recorder.calls[-1][1][3] == lse.data_ptr()
    assert (la.long_attention_qkv.launches, la.long_attention_bwd.launches) == (f0 + 2, b0 + 4)
    x = torch.zeros(1, 130, 3 * 64)
    la.long_attention_qkv(x, 1, 64)
    la.long_attention_bwd(x, torch.zeros(1, 130, 64), 1, 64)
    assert [c[0] for c in recorder.calls[-2:]] == ["qvt_attention_long", "qvt_attention_long_bwd"]
    with pytest.raises(ValueError, match="unsupported"):
        la.long_attention_qkv(torch.zeros(1, 7000, 3 * 64), 1, 64)


def test_training_pair_saves_the_statistics(recorder):
    """The bf16 training pair on the kernel path launches the forward once
    with a log-sum-exp and hands the backward the saved output and
    log-sum-exp (no second forward); on the CPU it stays the plain pair."""
    qkv, do = _qkv_do(1, 96, 2, 32, 4)
    x = qkv.clone().requires_grad_(True)
    la.long_attention_train(x, 2, 32).float().backward(do.float())
    names = [c[0] for c in recorder.calls]
    assert names == ["qvt_attention_long_mma", "qvt_attention_long_bwd_mma"]
    fwd, bwd = (c[1] for c in recorder.calls)
    assert bwd[1] == fwd[1] and bwd[3] == fwd[2] is not None


def test_cpu_pair_ignores_the_statistics():
    """On the CPU the backward is the plain version and ignores ``out`` and
    ``lse``; the training pair there equals the plain versions."""
    qkv, do = _qkv_do(1, 70, 2, 16, 5)
    want = la.long_attention_bwd_plain(qkv, do, 2, 16)
    junk = torch.full((1, 70, 32), 7.0, dtype=BF16), torch.zeros(1, 2, 70)
    assert torch.equal(la.long_attention_bwd(qkv, do, 2, 16, out=junk[0], lse=junk[1]), want)
    x = qkv.clone().requires_grad_(True)
    out = la.long_attention_train(x, 2, 16)
    out.float().backward(do.float())
    assert torch.equal(out, la.long_attention_qkv_plain(qkv, 2, 16))
    assert torch.equal(x.grad, want)
    assert la.rel_l2(x.grad, want) == 0.0
