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
and 128. K6a (``csrc/attention_long_q_mma.cu``) is modelled too: the
two-pass form with o quantized, in both score forms, held to the card's
int8 bound against its plain versions and run as the K6 chain's attention
against JAX's ``megamodel_long``. Also on the CPU: ``tc_errors`` on planted
faults, the split gates, the preset's routing, K2c's packed weight and
gate, and the wrappers' launch arguments against a recording stand-in for
the kernel library. Inputs are numpy, seeded, and go to both packages.
"""

from functools import partial

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
from qat_vit_tpu.serve.int8_vit import int8_apply as jax_int8_apply
from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.models.vit import ViTConfig
from qat_vit_tpu_torch.ops import fused_serve as fs
from qat_vit_tpu_torch.ops import long_attention as la
from qat_vit_tpu_torch.ops.flash_attention import _q_scale, split_heads
from qat_vit_tpu_torch.ops.quantized_matmul import f32
from qat_vit_tpu_torch.serve.int8_vit import (
    _preset_kernel_opts,
    export_to_device,
    int8_apply,
    pack_gemm_weights,
)
from tests.test_torch_port_detect import (  # noqa: F401 (export, micro: module fixtures)
    _int8_close,
    _jax_interpret,
    export,
    micro,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _scores8(qk8, h, hd, out_q, n_valid, k0, k1):
    """The int8-score form's scores over keys [k0, k1): the corrected
    integer dot of the int8 q and k, exact (int64), times s_o²·hd^-0.5 in
    f32; keys >= n_valid at -1e30."""
    b, n, _ = qk8.shape
    q8, k8 = (t.to(torch.int64).reshape(b, n, h, hd).transpose(1, 2)
              for t in qk8.split(h * hd, dim=-1))
    k8 = k8[:, :, k0:k1]
    zq8 = int(f32(out_q["zero_point"])) - 128
    corr = (q8 @ k8.transpose(-1, -2) - zq8 * (q8.sum(-1, keepdim=True) + k8.sum(-1)[:, :, None])
            + hd * zq8 * zq8)
    s = corr.to(torch.float32) * la.q8_score_scale(out_q["scale"], hd)
    return s.masked_fill(torch.arange(k0, k1) >= n_valid, -1e30)


def _two_pass(qkv, h, hd, n_valid, tile, scores):
    """The two passes over ``tile`` keys at a time → the f32 ``p·v`` of
    every row, ``[B, H, N, hd]``: pass 1 keeps each row's running max m and
    sum l of exp2((s - m)·log2e) in f32, pass 2 recomputes the scores
    (``scores(k0, k1)``) and rounds p = exp2((s - m)·log2e)·(1/l) to bf16."""
    b, n, _ = qkv.shape
    _, _, _, v = _heads(qkv, h, hd)
    m = torch.full((b, h, n, 1), -1e30)
    l = torch.zeros((b, h, n, 1))
    for k0 in range(0, n, tile):
        s = scores(k0, min(n, k0 + tile))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        l = l * torch.exp2((m - m_new) * LOG2E) + torch.exp2((s - m_new) * LOG2E).sum(
            dim=-1, keepdim=True)
        m = m_new
    acc = torch.zeros((b, h, n, hd))
    for k0 in range(0, n, tile):
        k1 = min(n, k0 + tile)
        p = torch.exp2((scores(k0, k1) - m) * LOG2E) * (1 / l)
        acc = acc + p.to(BF16).float() @ v[:, :, k0:k1]
    return acc


def two_pass_forward(qkv, h, hd, n_valid=None, tile=TILE):
    """The two-pass form, measured beside the online one: each row's max and
    sum first, then the normalised p = exp(s - m) / l rounded to bf16, as
    the plain version and JAX round it."""
    n_valid = qkv.shape[1] if n_valid is None else n_valid
    acc = _two_pass(qkv, h, hd, n_valid, tile,
                    lambda k0, k1: _scores(qkv, h, hd, n_valid, k0, k1))
    return _packed(acc.to(BF16))


def two_pass_q(qkv, h, hd, out_q, quant_max=255.0, n_valid=None, qk8=None, tile=TILE):
    """K6a's algorithm (``csrc/attention_long_q_mma.cu``): the two-pass
    form (``_two_pass``) with o quantized to shifted int8 on ``out_q`` (multiply by 1/scale, round half
    to even), its scores from q scaled in bf16 and k, or with ``qk8`` the
    int8-score form's exact corrected integer dot."""
    n_valid = qkv.shape[1] if n_valid is None else n_valid
    if qk8 is None:
        scores = lambda k0, k1: _scores(qkv, h, hd, n_valid, k0, k1)  # noqa: E731
    else:
        scores = lambda k0, k1: _scores8(qk8, h, hd, out_q, n_valid, k0, k1)  # noqa: E731
    o = _packed(_two_pass(qkv, h, hd, n_valid, tile, scores))
    return fs.quantize_mul(o, fs.inv_scale(out_q["scale"]), f32(out_q["zero_point"]),
                           f32(quant_max))


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


Q_OUT = {"scale": torch.tensor(2.0 / 255), "zero_point": torch.tensor(128.0)}
Q8_OUT = {"scale": torch.tensor(0.03), "zero_point": torch.tensor(131.0)}


def _qk8(b, n, h, hd, seed):
    """Shifted int8 q and k on ``Q8_OUT``'s grid (z' = 3), ~N(z', 60): the
    scores then spread over a few units, as a trained model's do."""
    rng = np.random.default_rng(seed)
    v = np.clip(np.round(rng.normal(3, 60, (b, n, 2 * h * hd))), -128, 127).astype(np.int8)
    return torch.from_numpy(v)


@pytest.mark.parametrize("form", ["bf16", "i8"])
@pytest.mark.parametrize("b,n,h,hd,n_valid", SHAPES + [(1, 700, 1, 64, 650)])
def test_quantizing_two_pass_within_the_int8_bound(b, n, h, hd, n_valid, form):
    """K6a's tile algorithm (``two_pass_q``: two passes over 64-key tiles,
    the running max and sum in f32, the normalised p = exp2((s - m)·log2e)
    ·(1/l) rounded to bf16, o quantized) with torch's f32 matmuls for the
    two dots, against the index-order plain versions
    (``long_attention_qkv_plain(out_q=…)``, ``long_attention_q8_plain``), in
    both score forms, on ragged N, n_valid < N and hd 72 and 128: the
    card's int8 bound, max |diff| 1 and >= 99.9% identical. Only sum orders
    and exp2 against the f64 exp differ; measured here: one output a step
    off in one of the ten cases, the rest identical."""
    qkv, _ = _qkv_do(b, n, h, hd, n + 7 * hd)
    if form == "bf16":
        want = la.long_attention_qkv_plain(qkv, h, hd, out_q=Q_OUT, n_valid=n_valid)
        got = two_pass_q(qkv, h, hd, Q_OUT, n_valid=n_valid)
    else:
        qk8 = _qk8(b, n, h, hd, n + hd)
        want = la.long_attention_q8_plain(qk8, qkv, h, hd, out_q=Q8_OUT, n_valid=n_valid)
        got = two_pass_q(qkv, h, hd, Q8_OUT, n_valid=n_valid, qk8=qk8)
    assert got.dtype == want.dtype == torch.int8 and got.shape == want.shape
    _int8_close(got.numpy(), want.numpy())  # the card's bound: max |diff| 1, >= 99.9% exact
    assert len(torch.unique(want)) > 20  # o spans many grid steps


@pytest.mark.parametrize("i8", [False, True])
def test_k6_chain_on_the_two_pass_model_matches_jax(export, monkeypatch, i8):
    """The K6 chain (``megamodel_long``, and with ``i8`` its int8-score
    form) with K6a's two-pass model as its attention stage, against JAX's
    ``megamodel_long:64:32`` in one jitted interpret call, at micro size
    (17 tokens, 2 heads of 32, depth 2, feature mode): the bounds of
    ``test_long_chain_matches_jax``, mean |diff| <= 3e-3 and at most one
    grid step of the final LN; the model ran once per block."""
    jcfg, tcfg, jexp, texp = export
    calls = []
    plain_qkv = la.long_attention_qkv_plain

    def attention(qkv, h, hd, *, out_q=None, quant_max=255.0, n_valid=None):
        if out_q is None:
            return plain_qkv(qkv, h, hd, n_valid=n_valid)
        calls.append("bf16")
        return two_pass_q(qkv, h, hd, out_q, quant_max, n_valid)

    def attention_q8(qk8, qkv, h, hd, *, out_q, quant_max=255.0, n_valid=None):
        calls.append("i8")
        return two_pass_q(qkv, h, hd, out_q, quant_max, n_valid, qk8=qk8)

    monkeypatch.setattr(la, "long_attention_qkv_plain", attention)
    monkeypatch.setattr(la, "long_attention_q8_plain", attention_q8)
    flag = ":i8" if i8 else ""
    x = np.random.default_rng(3).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(_jax_interpret(
        partial(jax_int8_apply, cfg=jcfg, compute_dtype=jnp.bfloat16,
                fused="megamodel_long:64:32" + flag),
        jax.tree.map(jnp.asarray, jexp["tower"]), jnp.asarray(x)))
    got = int8_apply(texp["tower"], torch.from_numpy(x), tcfg, compute_dtype=BF16,
                     fused="megamodel_long:512:256" + flag)
    assert calls == ["i8" if i8 else "bf16"] * tcfg.depth
    assert got.shape == want.shape == (2, 17, 64)
    step = float(texp["tower"]["norm"]["out_q"]["scale"])
    diff = np.abs(got.numpy() - want)
    assert diff.mean() <= 3e-3 and diff.max() <= step * 1.001, (diff.mean(), diff.max(), step)


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
    K5a in f32 takes kernel A's f32 plan (N to 39,080 at hd 128), K5b in
    f32 kernel B's rows-pass plan (N to 18,472 at hd 128; its own earlier
    plan took 5,024); the training pair's gate keeps JAX's N cap (4,096),
    so it routes as before."""
    for hd in (8, 16, 60, 64, 72, 128, 136, 256):
        for n in (1, 2305, 6048, 6049, 7000, 100_000):
            assert la.long_attention_stream_ok(n, hd) == jax_long_shapes_ok(9, hd), (n, hd)
            assert la.long_attention_shapes_ok(n, hd) == jax_long_shapes_ok(9, hd), (n, hd)
            if n <= 39_080:
                assert (la.long_attention_shapes_ok(n, hd, torch.float32)
                        == jax_long_shapes_ok(9, hd)), (n, hd)
    assert not la.long_attention_stream_ok(0, 64) and not la.long_attention_shapes_ok(0, 64)
    assert la.long_attention_shapes_ok(7000, 64, torch.float32)
    assert not la.long_attention_shapes_ok(39_081, 128, torch.float32)
    assert (la.long_attention_bwd_shapes_ok(18_472, 128, torch.float32)
            and not la.long_attention_bwd_shapes_ok(18_473, 128, torch.float32))
    for dt in (BF16, torch.float32):
        assert la.long_attention_train_available(9, 64, 4096, dt)
        assert not la.long_attention_train_available(9, 64, 4097, dt)
        assert not la.long_attention_train_available(1, 64, 7000, dt)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_preset_routes_as_before_at_1600px(act):
    """The preset's long rungs take the streaming gate: at 1,600 px (10,001
    tokens) the port serves JAX's rung for OWLv2-pruned widths and others,
    never raising: the K6 chain where JAX's whole-model kernel fits (d 256),
    mixed_none + the long attention where it does not (d 576, 768), as at
    960 px (3,601 tokens) the K6 chain."""
    for heads, hd, rung in ((9, 64, "pallas_long"), (12, 64, "pallas_long"),
                            (2, 128, "megamodel_long")):
        geo = dict(embed_dim=heads * hd, num_heads=heads, image_size=1600, patch_size=16, act=act)
        want = jax_preset_kernel_opts(JaxViTConfig(**geo))
        got = _preset_kernel_opts(ViTConfig(**geo))
        assert ViTConfig(**geo).seq_len == 10_001
        assert got == {"fused": want["fused"].split(":")[0],
                       **({"attn_impl": want["attn_impl"]} if "attn_impl" in want else {})}
        assert rung in (got.get("attn_impl"), got["fused"]), (geo, got)
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
    forward first unless given ``out`` and ``lse``; f32 goes to kernel A's
    f32 kernel without ``in_fq`` and to kernel B's f32 rows and keys passes
    with K5b's arithmetic; every argument list matches its C signature."""
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
    assert [c[0] for c in recorder.calls[-3:]] == [
        "qvt_attention_fwd", "qvt_attention_long_bwd_rows", "qvt_attention_long_bwd_keys"]
    assert recorder.calls[-3][1][1] is None and recorder.calls[-3][1][9:12] == (0, 0.0, 0.0)
    x = torch.zeros(1, 7000, 3 * 64)
    la.long_attention_qkv(x, 1, 64)  # past the old plan: kernel A's plan takes it
    assert recorder.calls[-1][0] == "qvt_attention_fwd"
    la.long_attention_bwd(x, torch.zeros(1, 7000, 64), 1, 64)  # and kernel B's rows plan
    assert recorder.calls[-1][0] == "qvt_attention_long_bwd_keys"
    with pytest.raises(ValueError, match="unsupported"):  # past kernel B's rows plan
        la.long_attention_bwd(torch.zeros(1, 18_473, 3 * 128), torch.zeros(1, 18_473, 128), 1, 128)


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


def test_k6a_launch_arguments(recorder):
    """K6a's two wrappers hand the streaming kernels
    (``csrc/attention_long_q_mma.cu``) their arguments at 10,001 tokens,
    past the old score-row plan: q scale in bf16 or the int8 score factor
    s_o²·hd^-0.5 and z' = z_o - 128, the output grid, one launch each;
    hd 60 still raises."""
    b, n, h, hd = 1, 10_001, 1, 72
    qkv, _ = _qkv_do(b, n, h, hd, 2)
    out_q = {"scale": torch.tensor(0.05), "zero_point": torch.tensor(131.0)}
    before = la.long_attention_q.launches, la.long_attention_q8.launches
    out = la.long_attention_qkv(qkv, h, hd, out_q=out_q, n_valid=9_999)
    name, args = recorder.calls[-1]
    assert name == "qvt_attention_long_q_mma" and out.dtype == torch.int8
    assert args[:2] == (qkv.data_ptr(), out.data_ptr()) and args[2:7] == (b, n, h, hd, 9_999)
    assert args[7] == float(torch.tensor(hd ** -0.5, dtype=BF16))
    assert args[8:11] == (fs.inv_scale(0.05), 131.0, 255.0)
    qk8 = torch.zeros(b, n, 2 * h * hd, dtype=torch.int8)
    out8 = la.long_attention_q8(qk8, qkv, h, hd, out_q=out_q, quant_max=127.0)
    name, args = recorder.calls[-1]
    assert name == "qvt_attention_long_q8_mma"
    assert args[:3] == (qk8.data_ptr(), qkv.data_ptr(), out8.data_ptr())
    assert args[3:8] == (b, n, h, hd, n) and args[8] == la.q8_score_scale(0.05, hd)
    assert args[9:13] == (3, fs.inv_scale(0.05), 131.0, 127.0)
    assert (la.long_attention_q.launches, la.long_attention_q8.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="unsupported"):
        la.long_attention_q(torch.zeros(1, 64, 3 * 60, dtype=BF16), 1, 60, out_q=out_q)
    with pytest.raises(ValueError, match="dtype"):  # the int8 forms are bf16-only
        la.long_attention_q(torch.zeros(1, 64, 3 * 64), 1, 64, out_q=out_q)


# ---------------------------------------------------------------------------
# K2c: the RESID_LN_Q GEMM's packed weight, gate and launch
# ---------------------------------------------------------------------------

def _resid_layer(rng, k, n):
    w = np.clip(np.round(rng.normal(0, 20, (k, n))), -128, 127).astype(np.int8)
    return {"w_int8": torch.from_numpy(w), "w_scale": torch.tensor(0.002),
            "w_colsum": torch.from_numpy(w.astype(np.int32).sum(0, dtype=np.int32)),
            "bias": torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32))}


def test_k2c_weight_packing(export):
    """``pack_gemm_weights`` (which ``export_to_device`` runs for a CUDA
    device, and only there) adds to every GEMM layer (each block's qkv,
    proj, fc1 and fc2, the patch embedding) ``w_int8_t``, numpy's
    k-contiguous transpose of ``w_int8``, and changes nothing else: the
    export's own tree stays the JAX layout, and an export placed on the CPU
    gets no packed copy."""
    _, _, jexp, texp = export
    on_cpu = export_to_device(texp["tower"], "cpu")
    assert all("w_int8_t" not in layer for blk in on_cpu["blocks"].values()
               for layer in blk.values() if isinstance(layer, dict))
    dev = pack_gemm_weights(texp["tower"])
    packed = []
    gemms = ("qkv", "proj", "fc1", "fc2")
    for i, blk in dev["blocks"].items():
        for name, layer in blk.items():
            src = texp["tower"]["blocks"][i][name]
            if name in gemms:
                w = np.asarray(jexp["tower"]["blocks"][i][name]["w_int8"])
                t = layer["w_int8_t"]
                assert t.is_contiguous() and t.dtype == torch.int8
                np.testing.assert_array_equal(t.numpy(), np.ascontiguousarray(w.T))
                packed.append(name)
                assert "w_int8_t" not in src
            assert set(layer) == set(src) | ({"w_int8_t"} if name in gemms else set())
            for k, v in src.items() if isinstance(src, dict) else ():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(layer[k], v), (i, name, k)
    assert sorted(packed) == sorted(list(gemms) * len(dev["blocks"]))
    np.testing.assert_array_equal(dev["patch_embed"]["w_int8_t"].numpy(),
                                  np.ascontiguousarray(texp["tower"]["patch_embed"]["w_int8"].numpy().T))
    np.testing.assert_array_equal(fs.pack_k_major(torch.arange(6, dtype=torch.int8).view(2, 3)),
                                  np.array([[0, 3], [1, 4], [2, 5]], np.int8))


def test_k2c_gate_and_block_rows():
    """The RESID_LN gate (K a multiple of 16: the k-steps past K are
    zero-filled; 1 <= N <= 1,756, the N K9's 32-row body holds) and the
    pipelined kernel's plan holds
    every N it admits: the block rows of ``resid_ln_rows`` fit the shared
    memory, 16 rows fit at N 1,756, and the height with the most rows in
    flight per SM is taken: OWLv2's N 576 64 rows (one block per SM),
    ViT-S's N 384 32 rows (two blocks per SM), whatever M."""
    assert fs.RESID_LN_MAX_N == 1756
    for k in (32, 64, 100, 384, 576, 1536, 3072):
        for n in (1, 10, 384, 576, 768, 1024, 1536, 1756, 1757, 3072):
            ok = fs.gemm_shapes_ok(k, n, resid_ln=True)
            assert ok == (k % 16 == 0 and n <= 1756), (k, n)
            if ok:
                for m in (1, 37, 4610, 6304, 18_440, 50_432):
                    r = fs.resid_ln_rows(m, n)
                    assert r in fs.RESID_LN_BLOCK_ROWS
                    assert fs.resid_ln_smem_bytes(r, n) <= la.SMEM_LIMIT, (m, n, r)
    assert fs.resid_ln_smem_bytes(16, 1756) <= la.SMEM_LIMIT
    assert fs.resid_ln_rows(2 * 2305, 576) == 64 == fs.resid_ln_rows(8 * 2305, 576)
    assert fs.resid_ln_rows(32 * 197, 384) == 32 == fs.resid_ln_rows(256 * 197, 384)
    assert fs.resid_ln_smem_bytes(64, 576) > fs.SM_SMEM_BYTES // 2  # one block per SM
    assert 2 * (fs.resid_ln_smem_bytes(32, 384) + fs.BLOCK_SMEM_RESERVE) <= fs.SM_SMEM_BYTES
    assert fs.resid_ln_rows(37, 384) == 32 and fs.resid_ln_rows(300, 1756) == 16


def test_k2c_launch_arguments(recorder, monkeypatch):
    """``int8_dense_resid_ln_q`` launches ``qvt_int8_gemm_resid_ln`` with
    the layer's packed weight, the block rows of ``resid_ln_rows`` and the
    output and residual types; one launch per call; a layer without a
    packed weight raises before any launch; the other epilogues keep
    ``qvt_int8_gemm``."""
    monkeypatch.setattr(fs, "use_plain", lambda t: False)
    monkeypatch.setattr(fs, "stream_of", lambda dev: 0)
    rng = np.random.default_rng(9)
    m, k, n = 2 * 2305, 3072, 576
    x = torch.from_numpy(rng.integers(-128, 128, (2, 2305, k), dtype=np.int8))
    layer = fs.with_packed_weight(_resid_layer(rng, k, n))
    res = torch.zeros(2, 2305, n)
    ln = {"scale": torch.ones(n), "bias": torch.zeros(n)}
    in_q = {"scale": torch.tensor(0.02), "zero_point": torch.tensor(121.0)}
    before = fs.int8_dense_resid_ln_q.launches
    y, q = fs.int8_dense_resid_ln_q(x, layer, in_q, res, ln, Q_OUT, eps=1e-5)
    name, args = recorder.calls[-1]
    assert name == "qvt_int8_gemm_resid_ln" and y.shape == (2, 2305, n) and q.dtype == torch.int8
    assert args[:2] == (x.data_ptr(), layer["w_int8_t"].data_ptr())
    assert args[5] == res.data_ptr() and args[8:10] == (y.data_ptr(), q.data_ptr())
    assert args[10:17] == (m, n, k, 64, 1, 0, 0)
    assert args[17:25] == (float(np.float32(0.002)), float(np.float32(0.02)), -7,
                           fs.inv_scale(Q_OUT["scale"]), 128.0, 255.0, 1e-5, 0)
    fs.int8_dense_resid_ln_q(x[:1, :18].contiguous(), layer, in_q,
                             res[:1, :18].to(BF16).contiguous(), ln, Q_OUT,
                             out_dtype=torch.float32)
    name, args = recorder.calls[-1]
    assert name == "qvt_int8_gemm_resid_ln" and args[10:17] == (18, n, k, 64, 0, 1, 0)
    bare = {kk: v for kk, v in layer.items() if kk != "w_int8_t"}
    calls = len(recorder.calls)
    with pytest.raises(ValueError, match="w_int8_t"):
        fs.int8_dense_resid_ln_q(x, bare, in_q, res, ln, Q_OUT, eps=1e-5)
    assert len(recorder.calls) == calls
    assert fs.int8_dense_resid_ln_q.launches == before + 2
    fs.int8_dense(x, layer, in_q)
    assert recorder.calls[-1][0] == "qvt_int8_gemm"
