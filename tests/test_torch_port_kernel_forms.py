"""Port parity for the last kernel forms of the JAX package, at micro size,
on the CPU:

- K6's ``int8_scores`` (the ``i8`` serving flag): the qkv GEMM's PLAIN_Q8
  epilogue (``int8_dense_q8_plain``) and the int8-score attention
  (``long_attention_q8_plain``) against numpy references, exactly, and
  against JAX ``long_block_forward(int8_scores=True)``; the ``i8`` chain
  against JAX's ``megamodel_long:64:32:i8`` and the exact path;
- the f32 forms of the training attention: kernels A and B (with and
  without ``in_fq``) and the long pair K5a/K5b through their plain versions
  against the JAX Pallas kernels in interpret mode; the route an f32 or
  bf16 fast_math model takes, against JAX's gates (``QVT_ATTN_INTERPRET=1``),
  equal everywhere but at hd < 8;
- the serving preset past every kernel gate: ``{}``, the bf16 exact path,
  exactly where JAX's preset gives ``{}``.

Inputs are numpy, seeded, and go to both packages; exports cross by
``models/jax_params.py``.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from qat_vit_tpu.models.vit import ViTConfig as JaxViTConfig
from qat_vit_tpu.ops import flash_attention_train as jax_fat
from qat_vit_tpu.ops import long_attention as jax_la
from qat_vit_tpu.ops.long_block_kernel import long_block_forward as jax_long_block_forward
from qat_vit_tpu.serve.int8_vit import _preset_kernel_opts as jax_preset_kernel_opts
from qat_vit_tpu.serve.int8_vit import int8_apply as jax_int8_apply
from qat_vit_tpu_torch.models import vit as port_vit
from qat_vit_tpu_torch.models.jax_params import export_from_numpy
from qat_vit_tpu_torch.models.registry import create_model
from qat_vit_tpu_torch.models.vit import ViTConfig
from qat_vit_tpu_torch.ops import flash_attention_train as fat
from qat_vit_tpu_torch.ops import fused_serve as fs
from qat_vit_tpu_torch.ops import long_attention as la
from qat_vit_tpu_torch.ops.long_block_kernel import LONG_PLAIN_OPS, long_block_forward
from qat_vit_tpu_torch.quant.qconfig import default_qat_qconfig
from qat_vit_tpu_torch.serve.int8_vit import (
    _parse_fused,
    _preset_kernel_opts,
    convert_vit,
    int8_apply,
    serving_preset,
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


OUT_Q = {"scale": np.float32(0.05), "zero_point": np.float32(131.0)}


def _tq(q):
    return {k: torch.tensor(v) for k, v in q.items()}


def _layer(rng, k, n):
    w = np.clip(np.round(rng.normal(0, 20, (k, n))), -128, 127).astype(np.int8)
    return {"w_int8": torch.from_numpy(w),
            "w_colsum": torch.from_numpy(w.astype(np.int32).sum(0, dtype=np.int32)),
            "bias": torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)),
            "w_scale": torch.tensor(0.002)}


def _q8_np(y, scale, zp, qmax=255.0):
    """The shifted-int8 quantize (multiply by 1/s in f32, add zp, round half
    to even, clip), in numpy f32."""
    inv = np.float32(1.0) / np.float32(scale)
    return (np.clip(np.rint(y * inv + np.float32(zp)), 0, qmax) - 128).astype(np.int8)


# ---------------------------------------------------------------------------
# K6 with int8 scores: the two stages' plain versions
# ---------------------------------------------------------------------------

def test_int8_dense_q8_plain():
    """(a) PLAIN_Q8: ``y`` is ``int8_dense_plain``'s, bit for bit, and the
    int8 q/k columns are the quantize of the f32 ``y`` (not of its bf16
    rounding), exactly as numpy computes it; they differ from a quantize of
    the rounded output somewhere. A layer that is not a packed qkv raises."""
    rng = np.random.default_rng(0)
    d = 64
    x = torch.from_numpy(rng.integers(-128, 128, (2, 17, d), dtype=np.int8))
    layer, in_q = _layer(rng, d, 3 * d), _tq({"scale": np.float32(0.02),
                                             "zero_point": np.float32(121.0)})
    y, q8 = fs.int8_dense_q8_plain(x, layer, in_q, _tq(OUT_Q))
    assert y.dtype == torch.bfloat16 and q8.shape == (2, 17, 2 * d) and q8.dtype == torch.int8
    assert torch.equal(y, fs.int8_dense_plain(x, layer, in_q, out_dtype=torch.bfloat16))
    y32 = fs.int8_dense_plain(x, layer, in_q, out_dtype=torch.float32).numpy()
    want = _q8_np(y32[..., :2 * d], OUT_Q["scale"], OUT_Q["zero_point"])
    np.testing.assert_array_equal(q8.numpy(), want)
    from_bf16 = _q8_np(y.float().numpy()[..., :2 * d], OUT_Q["scale"], OUT_Q["zero_point"])
    assert (from_bf16 != want).any()
    assert torch.equal(fs.int8_dense_q8(x, layer, in_q, _tq(OUT_Q))[1], q8)
    with pytest.raises(ValueError, match="packed"):  # q and k are the first two thirds
        fs.int8_dense_q8(x, _layer(rng, d, 2 * d), in_q, _tq(OUT_Q))


def _attention_q8_reference(qk8, qkv, heads, hd, n_valid, out_q):
    """The int8-score attention in numpy: the corrected score in int64, the
    f32 factor, the f64 softmax rounded as the kernels round it, p in bf16,
    p @ v in f32 in key order, the output quantize."""
    b, n, _ = qkv.shape
    d = heads * hd
    zq8 = int(out_q["zero_point"]) - 128
    sscale = np.float32(out_q["scale"]) * np.float32(out_q["scale"]) * np.float32(hd ** -0.5)
    q8 = qk8[..., :d].astype(np.int64).reshape(b, n, heads, hd)
    k8 = qk8[..., d:].astype(np.int64).reshape(b, n, heads, hd)
    corr = (np.einsum("bqhd,bkhd->bhqk", q8, k8)
            - zq8 * (q8.sum(-1).transpose(0, 2, 1)[..., :, None]
                     + k8.sum(-1).transpose(0, 2, 1)[..., None, :]) + hd * zq8 * zq8)
    s = corr.astype(np.float32) * sscale
    s[..., n_valid:] = np.float32(-1e30)
    e = np.exp((s - s.max(-1, keepdims=True)).astype(np.float64)).astype(np.float32)
    p = (e.astype(np.float64) / e.astype(np.float64).sum(-1, keepdims=True)).astype(np.float32)
    p = p.astype(ml_dtypes.bfloat16).astype(np.float32)
    v = qkv[..., 2 * d:].astype(np.float32).reshape(b, n, heads, hd).transpose(0, 2, 1, 3)
    o = np.zeros((b, heads, n, hd), np.float32)
    for j in range(n):
        o = o + p[..., j : j + 1] * v[:, :, j : j + 1, :]
    return _q8_np(o.transpose(0, 2, 1, 3).reshape(b, n, d), out_q["scale"], out_q["zero_point"])


@pytest.mark.parametrize("n,n_valid", [(40, 40), (40, 33)])
def test_long_attention_q8_plain_matches_numpy(n, n_valid):
    """(b) The int8-score attention's plain version equals the numpy
    reference exactly (integer scores exact in int64 there and in f64 in
    the port), with and without masked keys; it takes its q and k from
    ``qk8`` alone."""
    rng = np.random.default_rng(n_valid)
    heads, hd = 3, 16
    qk8 = rng.integers(-128, 128, (2, n, 2 * heads * hd), dtype=np.int8)
    qkv = rng.normal(0, 1, (2, n, 3 * heads * hd)).astype(ml_dtypes.bfloat16)
    t_qkv = torch.from_numpy(qkv.astype(np.float32)).to(torch.bfloat16)
    got = la.long_attention_q8_plain(torch.from_numpy(qk8), t_qkv, heads, hd, out_q=_tq(OUT_Q),
                                     n_valid=n_valid)
    want = _attention_q8_reference(qk8, qkv, heads, hd, n_valid, OUT_Q)
    np.testing.assert_array_equal(got.numpy(), want)
    other = t_qkv.clone()
    other[..., : 2 * heads * hd] = 0  # q and k of the bf16 qkv are not read
    assert torch.equal(la.long_attention_q8(torch.from_numpy(qk8), other, heads, hd,
                                            out_q=_tq(OUT_Q), n_valid=n_valid), got)


def test_long_block_int8_scores_matches_jax(export):
    """(b) One long block with ``int8_scores`` through the plain ops against
    JAX ``long_block_forward(int8_scores=True)`` in interpret mode (17
    tokens padded to 128 there), on block 0 of the micro detector export:
    the int8 rows within one step (99% exact) and the bf16 stream within one
    bf16 step of its scale; the chain without int8 scores differs."""
    jcfg, tcfg, jexp, texp = export
    rng = np.random.default_rng(5)
    n, n_pad, d = 17, 128, 64
    zq = rng.integers(-128, 128, (2, n, d), dtype=np.int8)
    x = rng.normal(0, 1, (2, n, d)).astype(ml_dtypes.bfloat16)
    jblk, jnxt = jexp["tower"]["blocks"]["0"], jexp["tower"]["blocks"]["1"]["norm1"]
    pad = ((0, 0), (0, n_pad - n), (0, 0))
    jx, jzq = _jax_interpret(
        partial(jax_long_block_forward, num_heads=2, head_dim=32, act="quick_gelu", eps=1e-5,
                n_valid=n, q_tile=128, row_chunk=128, int8_scores=True),
        jnp.asarray(np.pad(zq, pad)), jnp.asarray(np.pad(x, pad)),
        jax.tree.map(jnp.asarray, jblk), jax.tree.map(jnp.asarray, jnxt))
    tblk, tnxt = texp["tower"]["blocks"]["0"], texp["tower"]["blocks"]["1"]["norm1"]
    kw = dict(num_heads=2, head_dim=32, act="quick_gelu", eps=1e-5, n_valid=n, ops=LONG_PLAIN_OPS)
    tz, tx = torch.from_numpy(zq), torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    x1, z1 = long_block_forward(tz, tx, tblk, tnxt, int8_scores=True, **kw)
    _int8_close(z1.numpy(), np.asarray(jzq)[:, :n], min_exact=0.99)
    jxf = np.asarray(jx.astype(jnp.float32))[:, :n]
    assert np.abs(x1.float().numpy() - jxf).max() <= 2 ** -7 * np.abs(jxf).max()
    x0, z0 = long_block_forward(tz, tx, tblk, tnxt, **kw)
    assert not torch.equal(z0, z1)


# ---------------------------------------------------------------------------
# the i8 chain
# ---------------------------------------------------------------------------

def test_i8_chain_matches_jax(export):
    """(c) ``megamodel_long:64:32:i8`` through the plain versions against
    JAX's in one jitted interpret call, feature mode (the dequantized
    tokens), with the bounds of ``test_long_chain_matches_jax``: mean |diff|
    <= 3e-3 and at most one grid step of the final LN."""
    jcfg, tcfg, jexp, texp = export
    x = np.random.default_rng(3).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(_jax_interpret(
        partial(jax_int8_apply, cfg=jcfg, compute_dtype=jnp.bfloat16,
                fused="megamodel_long:64:32:i8"),
        jax.tree.map(jnp.asarray, jexp["tower"]), jnp.asarray(x)))
    got = int8_apply(texp["tower"], torch.from_numpy(x), tcfg, compute_dtype=torch.bfloat16,
                     fused="megamodel_long:64:32:i8")
    assert got.shape == want.shape == (2, 17, 64)
    step = float(texp["tower"]["norm"]["out_q"]["scale"])
    diff = np.abs(got.numpy() - want)
    assert diff.mean() <= 3e-3 and diff.max() <= step * 1.001, (diff.mean(), diff.max(), step)
    bf16 = int8_apply(texp["tower"], torch.from_numpy(x), tcfg, compute_dtype=torch.bfloat16,
                      fused="megamodel_long")
    assert not torch.equal(got, bf16)


def _quick_gelu_classifier():
    """The JAX package's micro CLIP-style classifier export (pre-norm,
    quick-GELU, bias-free patches: tests/test_fused_serve.py), carried into
    the port with its config."""
    from tests.test_fused_serve import _quick_gelu_export

    qp, x, _ = _quick_gelu_export(batch=3)
    cfg = ViTConfig(embed_dim=128, depth=2, num_heads=2, image_size=32, patch_size=8,
                    pre_norm=True, act="quick_gelu", patch_bias=False, num_classes=10,
                    quant=default_qat_qconfig(), qat_wrapper=True)
    return export_from_numpy(jax.device_get(qp)), torch.from_numpy(np.array(x)), cfg


def test_i8_modes_identical_and_close_to_exact():
    """(d) ``megablock_long:…:i8`` is ``megamodel_long:…:i8`` bit for bit,
    and both equal their ``*_plain`` twins; against the exact path they
    agree in argmax within JAX's own rtol/atol 0.06
    (``tests/test_fused_serve.py::test_int8_scores_matches_exact``)."""
    qp, x, cfg = _quick_gelu_classifier()
    kw = dict(compute_dtype=torch.bfloat16)
    got = int8_apply(qp, x, cfg, fused="megablock_long:64:32:i8", **kw)
    for mode in ("megamodel_long:512:256:su5:i8", "megablock_long:64:32:i8:su5:cu2:bb2",
                 "megamodel_long_plain::32:i8", "megablock_long_plain:64:32:bb2:i8"):
        assert torch.equal(int8_apply(qp, x, cfg, fused=mode, **kw), got), mode
    base = int8_apply(qp, x, cfg)
    assert (base.argmax(-1) == got.argmax(-1)).all()
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=0.06, atol=0.06)


def test_i8_flag_parsing():
    """``i8`` in any flag position, with ``su``/``cu``/``bb``; not as a
    q_tile or row_chunk; the preset never emits it."""
    assert _parse_fused("megamodel_long:512:256:i8") == ("megamodel_long", False, True)
    assert _parse_fused("megablock_long_plain:64:32:su5:i8:bb2") == ("megablock_long", True, True)
    assert _parse_fused("megamodel_long:512:256:su5") == ("megamodel_long", False, False)
    assert _parse_fused("megamodel:4:tight") == ("megamodel", False, False)
    for bad in ("megamodel_long:i8", "megamodel_long:512:i8", "megamodel_long:512:256:i9"):
        with pytest.raises(ValueError):
            _parse_fused(bad)
    from qat_vit_tpu_torch.models.owlv2_detect import detector_config

    for cfg in (detector_config(pruned=True), detector_config(pruned=False)):
        assert "i8" not in _preset_kernel_opts(cfg)["fused"]


# ---------------------------------------------------------------------------
# the f32 forms of the training attention
# ---------------------------------------------------------------------------

# clips the N(0, 1) qkv beyond ~±2: the STE mask is not all ones. The scale is
# a power of two, so x / s is exact: XLA on the CPU fuses fq_tile's divide and
# add, which at another scale moves a rounding tie of x / s + zp (measured:
# one element in 17,280 at 4.2/255) where the kernels round each operation
QS = (2.0 ** -6, 127.0)


def _grads(port_fn, jax_fn, qkv, do):
    """(port out, port dqkv, JAX out, JAX dqkv) in f32 for the cotangent ``do``."""
    jq = jnp.asarray(qkv)
    jout, jgrad = jax.jit(lambda q: (jax_fn(q), jax.grad(
        lambda v: (jax_fn(v) * do).sum())(q)))(jq)
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = port_fn(x)
    (out * torch.from_numpy(do)).sum().backward()
    return out.detach().numpy(), x.grad.numpy(), np.asarray(jout), np.asarray(jgrad)


@pytest.mark.parametrize("fq", [False, True])
def test_attention_train_f32_forms_match_jax(fq):
    """(e) Kernels A and B in f32 (plain versions) against JAX's
    ``attention_train`` / ``attention_train_fq`` in interpret mode at 2
    heads of 64 and 45 tokens (padded to 64 there): the same math with f64
    softmax sums and exp in the port, multiply-then-add dots in index order,
    and no bf16 rounding of q, p or ds: forward to rtol 1e-5, dqkv to 2e-4
    (the TPU kernel test's bounds); the STE zeroes the same elements."""
    heads, hd, n = 2, 64, 45
    rng = np.random.default_rng(45)
    qkv = rng.normal(0, 1, (3, n, 3 * heads * hd)).astype(np.float32)
    do = rng.normal(0, 1, (3, n, heads * hd)).astype(np.float32)
    if fq:
        def port_fn(x):
            return fat.attention_train_fq(x, torch.tensor(QS, dtype=torch.float32), heads, hd,
                                          0, 255)

        def jax_fn(q):
            return jax_fat.attention_train_fq(q, jnp.asarray([QS], jnp.float32), heads, hd, 0,
                                              255, 4, True)
    else:
        def port_fn(x):
            return fat.attention_train(x, heads, hd)

        def jax_fn(q):
            return jax_fat.attention_train(q, heads, hd, 4, True)
    out, grad, jout, jgrad = _grads(port_fn, jax_fn, qkv, do)
    assert out.dtype == grad.dtype == np.float32
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, jgrad, rtol=2e-4, atol=2e-4)
    if fq:
        assert (grad == 0).mean() > 0.01 and ((grad == 0) == (jgrad == 0)).all()


def test_long_attention_train_f32_matches_jax(monkeypatch):
    """(e) K5a/K5b in f32 (plain versions) against JAX's
    ``long_attention_train`` in interpret mode at 2 heads of 16 and 130
    tokens (q tile 128: two stripes there; the port's plain stripes of 48
    rows: three), so both carry dk and dv across stripes: forward to rtol
    1e-5, dqkv to 2e-4."""
    monkeypatch.setattr(la, "PLAIN_Q_STRIPE", 48)
    heads, hd, n = 2, 16, 130
    rng = np.random.default_rng(130)
    qkv = rng.normal(0, 1, (2, n, 3 * heads * hd)).astype(np.float32)
    do = rng.normal(0, 1, (2, n, heads * hd)).astype(np.float32)
    out, grad, jout, jgrad = _grads(lambda x: la.long_attention_train(x, heads, hd),
                                    lambda q: jax_la.long_attention_train(q, heads, hd, 128, True),
                                    qkv, do)
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, jgrad, rtol=2e-4, atol=2e-4)


def _jax_branch(h, hd, n):
    """The branch JAX's ``Attention`` takes under fast_math + attn_kernel."""
    if jax_fat.attention_train_available(h, hd, seq_len=n):
        return "k1"
    if jax_la.long_attention_train_available(h, hd, seq_len=n):
        return "k5"
    return "einsum"


def _port_branch(h, hd, n, dtype):
    if fat.attention_train_available(h, hd, n, dtype):
        return "k1"
    if la.long_attention_train_available(h, hd, n, dtype):
        return "k5"
    return "einsum"


# geometries where JAX's gate admits K1 and the port does not, with the
# reason: the kernels take hd in multiples of 8, JAX any hd dividing 128
# (hd 1, 2 and 4 from 128, 64 and 32 heads, at short N: 64 here; the port
# takes the einsum form)
RESIDUE = {(128 // hd, hd): "hd % 8 != 0" for hd in (1, 2, 4)}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("QVT_ATTN_INTERPRET", "1")


def test_f32_route_matches_jax_gates(interpret):
    """(f) The port's gates take the dtype as JAX's do: f32 models take K1
    or the K5 pair where JAX does, at the micro shapes (2 heads of 64 at 17
    tokens: K1; 3 heads of 16: K5, the packed width 48 is not lane-aligned
    for JAX's K1), at ViT-S / ViT-B (197 tokens: K1) and OWLv2-pruned
    (2,305: K5); across hd 8-128, 1-16 heads wherever the packed width is a
    multiple of 128 lanes and N = 1..700, in both dtypes, the two agree
    everywhere; they part only at the listed hd < 8 geometries."""
    for h, hd, n, want in ((2, 64, 17, "k1"), (3, 16, 17, "k5"), (6, 64, 197, "k1"),
                           (12, 64, 197, "k1"), (9, 64, 2305, "k5"), (6, 60, 197, "einsum")):
        assert _jax_branch(h, hd, n) == want, (h, hd, n)
        for dt in (torch.float32, torch.bfloat16):
            assert _port_branch(h, hd, n, dt) == want, (h, hd, n, dt)
    scanned = 0
    for hd in (8, 16, 32, 64, 128):
        for h in range(1, 17):
            if (h * hd) % 128:
                continue
            for n in range(1, 701):
                want = _jax_branch(h, hd, n)
                for dt in (torch.float32, torch.bfloat16):
                    assert _port_branch(h, hd, n, dt) == want, (h, hd, n, dt, want)
                scanned += 1
    assert scanned == 31 * 700
    for (h, hd), reason in RESIDUE.items():
        assert _jax_branch(h, hd, 64) == "k1", reason
        for dt in (torch.float32, torch.bfloat16):
            assert _port_branch(h, hd, 64, dt) == "einsum", (h, hd, reason)


def test_f32_fast_math_models_take_the_kernel_branch(monkeypatch):
    """(f) A micro f32 fast_math ViT runs K1 (``attention_train``: once per
    block) and a micro f32 fast_math OWLv2 the K5 pair, through the gates
    alone, as JAX's ``Attention`` does for the same shapes."""
    from qat_vit_tpu_torch.models.owlv2_detect import create_detector

    calls = []
    for name in ("attention_train", "long_attention_train"):
        monkeypatch.setattr(port_vit, name, partial(
            lambda fn, tag, *a: calls.append(tag) or fn(*a), getattr(port_vit, name), name))
    vit = create_model("vit_micro_test", fast_math=True, generator=torch.Generator().manual_seed(0))
    assert vit.cfg.dtype == torch.float32 and vit.cfg.fast_math and vit.cfg.attn_kernel
    vit.module(torch.zeros(2, 32, 32, 3)).sum().backward()
    assert calls == ["attention_train"] * vit.cfg.depth
    calls.clear()
    det, cfg = create_detector(pruned=True, fast_math=True, image_size=32, patch_size=8,
                               embed_dim=48, depth=2, num_heads=3, mlp_ratio=2.0,
                               generator=torch.Generator().manual_seed(0))
    assert cfg.dtype == torch.float32
    det(torch.zeros(2, 32, 32, 3))["pred_boxes"].sum().backward()
    assert calls == ["long_attention_train"] * cfg.depth


# ---------------------------------------------------------------------------
# the serving preset past every gate
# ---------------------------------------------------------------------------

def test_preset_past_every_gate_is_the_bf16_exact_path():
    """(g) A geometry no kernel gate admits (hd 12: no attention kernel,
    D 48: no GEMM tile) gets ``{}`` from the rung ladder in both packages;
    the CUDA preset is then the exact path in bf16 with tanh-GELU, and its
    output equals that path's, with no kernel wrapper counted."""
    geo = dict(embed_dim=48, depth=1, num_heads=4, image_size=32, patch_size=8, num_classes=10)
    cfg = ViTConfig(quant=default_qat_qconfig(), qat_wrapper=True, **geo)
    assert _preset_kernel_opts(cfg) == {} == jax_preset_kernel_opts(JaxViTConfig(**geo))
    preset = serving_preset(cfg, "cuda")
    assert preset == {"attn_dtype": torch.bfloat16, "compute_dtype": torch.bfloat16,
                      "gelu_approx": True}
    m = port_vit.VisionTransformer(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (3, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        m(x, observe=True)
    sd = m.state_dict()
    qp = convert_vit({k: v for k, v in sd.items() if not k.endswith(("min_val", "max_val"))},
                     {k: v for k, v in sd.items() if k.endswith(("min_val", "max_val"))}, cfg)
    counts = [w.launches for w in (fs.int8_dense, fs.int8_dense_q8, la.long_attention_q8)]
    got = int8_apply(qp, x, cfg, **preset)
    want = int8_apply(qp, x, cfg, fused="none", attn_dtype=torch.bfloat16,
                      compute_dtype=torch.bfloat16, gelu_approx=True)
    assert got.shape == (3, 10) and torch.isfinite(got).all() and torch.equal(got, want)
    assert [w.launches for w in (fs.int8_dense, fs.int8_dense_q8, la.long_attention_q8)] == counts
    assert not torch.equal(want, int8_apply(qp, x, cfg))  # bf16, not the f32 defaults


# the rungs of the serving preset, in ladder order, by (fused kind, attn_impl)
RUNGS = {("megamodel", None): 1, ("mixed_none", "pallas_fused"): 2, ("megamodel_long", None): 3,
         ("mixed_none", "pallas_long"): 4}


def rung(opts: dict) -> int:
    """The ladder position of a preset's kernel options (5: the exact path)."""
    if not opts:
        return 5
    return RUNGS[(opts["fused"].split(":")[0], opts.get("attn_impl"))]


def block_gemms_ok(cfg) -> bool:
    """int8_gemm takes every GEMM of a block (K a multiple of 16)."""
    d = cfg.embed_dim
    return (fs.gemm_shapes_ok(d, 3 * d) and fs.gemm_shapes_ok(d, d, resid_ln=True)
            and fs.gemm_shapes_ok(d, cfg.mlp_dim)
            and fs.gemm_shapes_ok(cfg.mlp_dim, d, resid_ln=True))


# Where the port's rung departs from JAX's on the grid below, and why: JAX's
# rung 3 (its whole-model long kernel) at a width d = 8 (mod 16), where
# int8_gemm cannot take the block GEMMs (TMA and cp.async read rows of 16
# bytes), so the port serves the next rung down, mixed_none + the long
# attention (rung 4). Head dim 24 with 1, 3 or 9 heads, at 2,305 and 10,001
# tokens.
PRESET_RESIDUE = {(heads, 24, size) for heads in (1, 3, 9) for size in (768, 1600)}


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_preset_is_empty_exactly_where_jax_is(act):
    """(g) Across head counts, head dims and sequence lengths the port's
    preset never raises and picks JAX's rung on JAX's conditions, apart from
    the named residue (:data:`PRESET_RESIDUE`: JAX's rung 3 at widths int8_gemm
    rejects, where the port takes rung 4). So it is ``{}`` exactly where
    JAX's is, and at 1,600 px (10,001 tokens) both long rungs appear."""
    residue = set()
    at_1600 = []
    for heads in (1, 2, 3, 6, 9, 12):
        for hd in (12, 16, 24, 32, 60, 64, 96, 128, 136):
            for image_size, patch in ((32, 8), (224, 16), (480, 16), (768, 16), (1600, 16)):
                geo = dict(embed_dim=heads * hd, num_heads=heads, image_size=image_size,
                           patch_size=patch, act=act)
                cfg = ViTConfig(**geo)
                want, got = rung(jax_preset_kernel_opts(JaxViTConfig(**geo))), rung(
                    _preset_kernel_opts(cfg))
                assert (got == 5) == (want == 5), (geo, got, want)
                if image_size == 1600:
                    at_1600.append((got, want))
                if got == want:
                    continue
                assert (want, got) == (3, 4) and not block_gemms_ok(cfg), (geo, got, want)
                residue.add((heads, hd, image_size))
    # the 10,001-token geometries: both long rungs, each where JAX takes it
    assert {(3, 3), (4, 4)} <= set(at_1600), at_1600
    assert residue == PRESET_RESIDUE, residue ^ PRESET_RESIDUE


# The other named departure: JAX's rung 1 (its whole-model slab kernel) at an
# MLP width of 8 (mod 16), where int8_gemm cannot take fc1's output width as
# fc2's K, so the port serves rung 2 (mixed_none + K3, its GEMMs plain). The
# grid above has mlp = 4 d and never reaches it: (heads, head dim, mlp dim).
MLP_RESIDUE = {(1, 128, 1000), (2, 64, 1000), (4, 64, 1032)}


def test_preset_rung1_residue_at_mlp_width_8_mod_16():
    """(g) At widths JAX serves on its megamodel rung, an MLP width of
    8 (mod 16) is the port's one departure there: rung 2, named in
    :data:`MLP_RESIDUE`. At mlp 16 (mod 32) both take rung 1."""
    residue = set()
    for heads, hd, mlp in sorted(MLP_RESIDUE) + [(2, 64, 1008), (4, 64, 1040)]:
        geo = dict(embed_dim=heads * hd, num_heads=heads, mlp_ratio=mlp / (heads * hd))
        cfg = ViTConfig(**geo)
        assert cfg.mlp_dim == mlp
        want, got = rung(jax_preset_kernel_opts(JaxViTConfig(**geo))), rung(
            _preset_kernel_opts(cfg))
        assert want == 1, (geo, want)
        if got != want:
            assert got == 2 and not block_gemms_ok(cfg), (geo, got)
            residue.add((heads, hd, mlp))
        else:
            assert block_gemms_ok(cfg), geo
    assert residue == MLP_RESIDUE, residue ^ MLP_RESIDUE
