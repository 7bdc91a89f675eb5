"""Port parity for the rest of int8 ViT serving, at micro size
(``vit_micro_test``: D 128, depth 2, 2 heads, hd 64, 32 px, 17 tokens).

The same numpy-seeded inputs and the same JAX export go through the JAX
package and the port:

- K7 (``fused_quantize_matmul``) plain vs JAX's Pallas kernel in interpret
  mode, K8 (``flash_attention_qkv``) likewise;
- the K9 modes (``megablock`` / ``megamodel_res``) and every ``pallas`` /
  ``mixed*`` chain with every ``attn_impl`` vs JAX ``int8_apply`` run as ONE
  jitted interpret call (the deadlock note on ``interpret_apply`` in
  tests/test_fused_serve.py);
- the exact path with ``use_pallas=True`` and K8 vs JAX under
  ``pltpu.force_tpu_interpret_mode()``;
- the preset's rungs against JAX's, the repaired ``fused`` forms
  (``megamodel:BB:tight``, ``True`` / ``False``) and the raises.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from qat_vit_tpu.models.registry import create_model as jax_create_model
from qat_vit_tpu.ops import pallas_gemm as jax_pallas_gemm
from qat_vit_tpu.ops.flash_attention import flash_attention_qkv as jax_flash_attention
from qat_vit_tpu.serve.int8_vit import _preset_kernel_opts as jax_preset_kernel_opts
from qat_vit_tpu.serve.int8_vit import convert_vit as jax_convert_vit
from qat_vit_tpu.serve.int8_vit import int8_apply as jax_int8_apply
from qat_vit_tpu_torch.models.jax_params import export_from_numpy
from qat_vit_tpu_torch.models.registry import create_model
from qat_vit_tpu_torch.ops import block_kernel as bk
from qat_vit_tpu_torch.ops.flash_attention import (
    flash_attention_shapes_ok,
    flash_attention_qkv,
    flash_attention_qkv_plain,
)
from qat_vit_tpu_torch.ops.pallas_gemm import (
    fused_quantize_matmul,
    fused_quantize_matmul_available,
    fused_quantize_matmul_plain,
)
from qat_vit_tpu_torch.serve.int8_vit import (
    _preset_kernel_opts,
    int8_apply,
    make_int8_forward,
)
from qat_vit_tpu_torch.serve.predictor import Int8Predictor


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MODES = ("pallas", "mixed", "mixed_qkv", "mixed_fc1", "mixed_none")
ATTN_IMPLS = ("xla", "pallas", "pallas_fused", "pallas_long")
# the fused chains vs JAX: both bf16 streams, but LN statistics and softmax
# sums are summed in another order (f64 here, f32 there) and bf16 GELU and
# casts round at other places, so a few int8 elements flip by one and the
# micro logits agree to this (as test_int8_apply_megamodel_matches_jax)
CHAIN_TOL = 2e-2


def _jax_interpret(fn, *args):
    """One jitted call under the Mosaic-TPU interpreter."""
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
    return out


@pytest.fixture(scope="module")
def export():
    """A JAX micro export (params + observed stats), as numpy and as the port's tree
    (init and the observing pass jitted: a third of their eager time)."""
    jm = jax_create_model("vit_micro_test", qat_wrapper=True)
    init = jax.jit(partial(jm.module.init, observe=False))
    v = nn.meta.unbox(init(jax.random.key(0), jm.example_input(1)))
    x = np.random.default_rng(0).normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    observe = jax.jit(partial(jm.module.apply, observe=True, mutable=["quant_stats"]))
    _, mut = observe({"params": v["params"], "quant_stats": v["quant_stats"]}, jnp.asarray(x))
    qp_np = jax.device_get(jax_convert_vit(v["params"], mut["quant_stats"], jm.cfg))
    tm = create_model("vit_micro_test", qat_wrapper=True)
    return jm.cfg, tm.cfg, qp_np, export_from_numpy(qp_np), x


def _gemm_case(rng, m, k, n, per_channel):
    x = rng.normal(0, 1.5, (m, k)).astype(np.float32)
    w = np.clip(np.round(rng.normal(0, 20, (k, n))), -128, 127).astype(np.int8)
    ws = (rng.uniform(1e-3, 3e-3, n).astype(np.float32) if per_channel
          else np.float32(0.002))
    return x, w, w.astype(np.int32).sum(0, dtype=np.int32), ws, rng.normal(0, 0.5, n).astype(np.float32)


# ---------------------------------------------------------------------------
# K7 and K8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("qmax", [255.0, 127.0])
def test_fused_quantize_matmul_matches_jax(per_channel, qmax):
    """K7's plain version against JAX's kernel in interpret mode, ragged M
    (160 rows: not a tile multiple), K 128, N 256. Both multiply by the f32
    reciprocal and the integer product is exact, so the int8 grid is the
    same; the port dequantizes with two f32 roundings, ``a·(s_x·w_s)`` then
    ``+ bias`` (the TPU's and the card's), which numpy reproduces exactly,
    while XLA on the CPU contracts them into one FMA: JAX within 1e-6 rel
    (as tests/test_int8_path.py's K7 test)."""
    rng = np.random.default_rng(int(qmax) + per_channel)
    x, w, colsum, ws, bias = _gemm_case(rng, 160, 128, 256, per_channel)
    s_x, zp = np.float32(4.0 / qmax), np.float32(100.0 if qmax == 255 else 60.0)
    want = jax_pallas_gemm.fused_quantize_matmul(
        jnp.asarray(x), jnp.asarray(w), x_scale=s_x, x_zero_point=zp, w_scale=jnp.asarray(ws),
        w_colsum=jnp.asarray(colsum), bias=jnp.asarray(bias), x_quant_max=qmax, interpret=True)
    kw = dict(x_scale=torch.tensor(s_x), x_zero_point=torch.tensor(zp),
              w_scale=torch.from_numpy(np.asarray(ws)) if per_channel else torch.tensor(ws),
              w_colsum=torch.from_numpy(colsum), bias=torch.from_numpy(bias), x_quant_max=qmax)
    got = fused_quantize_matmul(torch.from_numpy(x), torch.from_numpy(w), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    q = np.clip(np.round(x * (np.float32(1) / s_x) + zp), 0, qmax).astype(np.int64) - 128
    acc = (q @ w.astype(np.int64) - (int(zp) - 128) * colsum).astype(np.float32)
    sw = (np.float32(s_x) * np.asarray(ws, np.float32)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), (acc * sw).astype(np.float32) + bias)
    # a leading batch dim and a bf16 input reach the same arithmetic
    x3 = torch.from_numpy(x[:150]).reshape(2, 75, 128)
    got3 = fused_quantize_matmul(x3, torch.from_numpy(w), **kw)
    np.testing.assert_array_equal(got3.reshape(150, 256).numpy(), got[:150].numpy())
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        fused_quantize_matmul_plain(xb, torch.from_numpy(w), **kw).numpy(),
        fused_quantize_matmul_plain(xb.float(), torch.from_numpy(w), **kw).numpy())


def test_fused_quantize_matmul_gate():
    """JAX's shape conditions, without its backend test."""
    assert fused_quantize_matmul_available((6272, 768), (768, 384))
    assert fused_quantize_matmul_available((2, 197, 1536), (1536, 384))
    assert not fused_quantize_matmul_available((32, 384), (384, 10))  # N % 128
    assert not fused_quantize_matmul_available((32, 48), (48, 128))  # K % 32
    assert not fused_quantize_matmul_available((32, 4096), (4096, 2048))  # panel > 6 MiB
    assert not fused_quantize_matmul_available((32, 256), (128, 128))  # x K != w K
    assert fused_quantize_matmul_available((8, 96), (96, 128))  # K % 64 != 0: the card runs it


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [50, 197])
def test_flash_attention_matches_jax(dtype, n):
    """K8's plain version against JAX's kernel in interpret mode: scores
    dotted in f32, scaled after the dot, f32 softmax, p in the qkv dtype.
    f32: rel 1e-5 (softmax sums in f64 here, f32 there; dots in another
    order); bf16: within one bf16 ulp."""
    heads, hd = 2, 64
    b = 2 if n < 64 else 1  # the interpreter's time grows with the grid
    rng = np.random.default_rng(n)
    qkv = rng.normal(0, 1.5, (b, n, 3 * heads * hd)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_flash_attention(jnp.asarray(qkv, jdt), heads, hd, interpret=True),
                      np.float32)
    t = torch.from_numpy(qkv).to(tdt)
    got = flash_attention_qkv(t, heads, hd)
    assert got.dtype == tdt and got.shape == (b, n, heads * hd)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)
    # masked keys: n_valid < N equals attention over the first n_valid keys
    short = flash_attention_qkv_plain(t[:, : n - 7].contiguous(), heads, hd)
    masked = flash_attention_qkv_plain(t, heads, hd, n_valid=n - 7)[:, : n - 7]
    np.testing.assert_array_equal(masked.float().numpy(), short.float().numpy())


def test_flash_attention_gate():
    """K8's own gate runs kernel A's plans: past the CUDA-core tile's 789
    (bf16) and 420 (f32) tokens at hd 64 of the earlier kernel, bf16 at
    any N and f32 to the end of its plan; hd a multiple of 8 up to 128.
    K9's gate (``megablock_shapes_ok``) takes K3's, past the tile's 789 too."""
    for dt in (torch.bfloat16, torch.float32):
        assert flash_attention_shapes_ok(789, 64, dt) and flash_attention_shapes_ok(790, 64, dt)
        assert flash_attention_shapes_ok(421, 64, dt) and flash_attention_shapes_ok(577, 64, dt)
        assert not flash_attention_shapes_ok(197, 60, dt)
        assert not flash_attention_shapes_ok(197, 136, dt)
    assert flash_attention_shapes_ok(100_000, 128, torch.bfloat16)
    assert flash_attention_shapes_ok(39_080, 128, torch.float32)
    assert not flash_attention_shapes_ok(39_081, 128, torch.float32)
    assert bk.megablock_shapes_ok(789, 6, 64, 1536) and bk.megablock_shapes_ok(790, 6, 64, 1536)


# ---------------------------------------------------------------------------
# K9 and the fused chains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["megablock:2:tight", "megamodel_res:2:tight"])
def test_k9_modes_match_jax(export, mode):
    """K9a / K9b: logits identical to the port's megamodel chain (on the
    CPU both are the chain through the plain ops), and within the megamodel
    test's tolerance of JAX's whole-block kernels run as one jitted
    interpret call."""
    jcfg, tcfg, qp_np, qp_t, x = export
    want = np.asarray(_jax_interpret(
        partial(jax_int8_apply, cfg=jcfg, compute_dtype=jnp.bfloat16, fused=mode),
        jax.tree.map(jnp.asarray, qp_np), jnp.asarray(x)))
    got = int8_apply(qp_t, torch.from_numpy(x), tcfg, compute_dtype=torch.bfloat16, fused=mode)
    chain = int8_apply(qp_t, torch.from_numpy(x), tcfg, compute_dtype=torch.bfloat16,
                       fused="megamodel")
    np.testing.assert_array_equal(got.numpy(), chain.numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=CHAIN_TOL, atol=CHAIN_TOL)


@pytest.mark.parametrize("attn_impl", ATTN_IMPLS)
@pytest.mark.parametrize("mode", MODES)
def test_fused_chain_matches_jax(export, mode, attn_impl):
    """Every per-GEMM chain with every attention against JAX's, bf16 stream
    and attention, tanh-GELU; its ``*_plain`` twin is the same arithmetic."""
    jcfg, tcfg, qp_np, qp_t, x = export
    opts = dict(attn_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16, gelu_approx=True)
    want = np.asarray(_jax_interpret(
        partial(jax_int8_apply, cfg=jcfg, fused=mode, attn_impl=attn_impl, **opts),
        jax.tree.map(jnp.asarray, qp_np), jnp.asarray(x)))
    topts = dict(attn_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, gelu_approx=True,
                 attn_impl=attn_impl)
    got = int8_apply(qp_t, torch.from_numpy(x), tcfg, fused=mode, **topts).numpy()
    np.testing.assert_allclose(got, want, rtol=CHAIN_TOL, atol=CHAIN_TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    plain = int8_apply(qp_t, torch.from_numpy(x), tcfg, fused=mode + "_plain", **topts).numpy()
    np.testing.assert_array_equal(plain, got)


def test_exact_path_with_k7_k8_matches_jax(export, monkeypatch):
    """The exact path with ``use_pallas=True`` and ``attn_impl="pallas"``
    (K7 for the patch embed and every block GEMM, K8 for attention, in f32)
    against JAX's under the TPU interpreter. JAX's K7 gate returns False
    off the TPU, so JAX alone gets its shape conditions here; the port's
    gate has none. Logits agree as the exact paths do (f32 summation
    order, softmax sums in f64 here): 1e-3 and the argmax."""
    jcfg, tcfg, qp_np, qp_t, x = export
    monkeypatch.setattr(jax_pallas_gemm, "fused_quantize_matmul_available",
                        lambda xs, ws: fused_quantize_matmul_available(tuple(xs), tuple(ws)))
    calls = []
    real = jax_pallas_gemm.fused_quantize_matmul
    monkeypatch.setattr(jax_pallas_gemm, "fused_quantize_matmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want = np.asarray(_jax_interpret(
        partial(jax_int8_apply, cfg=jcfg, use_pallas=True, attn_impl="pallas"),
        jax.tree.map(jnp.asarray, qp_np), jnp.asarray(x)))
    assert len(calls) == 1 + 4 * tcfg.depth  # JAX took K7 for every GEMM but the head
    got = int8_apply(qp_t, torch.from_numpy(x), tcfg, use_pallas=True, attn_impl="pallas").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    # bf16 stream and attention (K8's bf16 form) and K7 on a bf16 input
    opts = dict(attn_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    got_bf16 = int8_apply(qp_t, torch.from_numpy(x), tcfg, use_pallas=True, attn_impl="pallas",
                          **opts).numpy()
    want_bf16 = np.asarray(_jax_interpret(
        partial(jax_int8_apply, cfg=jcfg, use_pallas=True, attn_impl="pallas",
                attn_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16),
        jax.tree.map(jnp.asarray, qp_np), jnp.asarray(x)))
    np.testing.assert_allclose(got_bf16, want_bf16, rtol=CHAIN_TOL, atol=CHAIN_TOL)


def test_exact_path_takes_k7_where_the_gate_admits(export, monkeypatch):
    """``use_pallas``: None → the division path; True → K7 for every layer
    its gate admits (the patch embed and 4 GEMMs per block; the 10-class
    head is not a GEMM of the block loop) and the division path elsewhere."""
    from qat_vit_tpu_torch.ops import pallas_gemm

    _, tcfg, _, qp_t, x = export
    calls = []
    real = pallas_gemm.fused_quantize_matmul_plain
    monkeypatch.setattr(pallas_gemm, "fused_quantize_matmul_plain",
                        lambda *a, **k: calls.append(a[1].shape) or real(*a, **k))
    base = int8_apply(qp_t, torch.from_numpy(x), tcfg)
    assert calls == []
    k7 = int8_apply(qp_t, torch.from_numpy(x), tcfg, use_pallas=True)
    assert len(calls) == 1 + 4 * tcfg.depth
    np.testing.assert_allclose(k7.numpy(), base.numpy(), rtol=2e-2, atol=2e-2)
    calls.clear()
    fused = int8_apply(qp_t, torch.from_numpy(x), tcfg, compute_dtype=torch.bfloat16,
                       fused="megamodel", use_pallas=True)
    assert calls == [qp_t["patch_embed"]["w_int8"].shape]  # the patch embed only
    np.testing.assert_allclose(fused.numpy(), base.numpy(), rtol=0.1, atol=0.1)


def test_k9_plain_versions_are_the_chain(export):
    """At block level: K9a's and K9b's plain versions are the K4 chain
    through the plain ops, and ``model_forward(resident=True)`` reaches
    K9b; tanh-GELU only."""
    _, tcfg, _, qp_t, x = export
    from qat_vit_tpu_torch.ops import fused_serve as fs
    from qat_vit_tpu_torch.serve.int8_vit import _embed

    xe = _embed(qp_t, torch.from_numpy(x), tcfg, torch.bfloat16, fs.int8_dense_plain)
    blk0 = qp_t["blocks"]["0"]
    zq = fs.ln_quantize(xe, blk0["norm1"], blk0["norm1"]["out_q"])
    kw = dict(num_heads=2, head_dim=64, n_valid=xe.shape[1])
    one = bk.megablock_forward(zq, xe, blk0, qp_t["blocks"]["1"]["norm1"], block_b=2, **kw)
    want = bk.block_forward(zq, xe, blk0, qp_t["blocks"]["1"]["norm1"], ops=bk.PLAIN_OPS, **kw)
    assert all(torch.equal(a, b) for a, b in zip(one, want))
    whole = bk.model_forward(zq, xe, qp_t["blocks"], qp_t["norm"], depth=2, resident=True, **kw)
    chain = bk.model_forward(zq, xe, qp_t["blocks"], qp_t["norm"], depth=2, **kw)
    assert all(torch.equal(a, b) for a, b in zip(whole, chain))
    with pytest.raises(NotImplementedError, match="tanh-GELU"):
        bk.model_forward(zq, xe, qp_t["blocks"], qp_t["norm"], depth=2, resident=True,
                         act="quick_gelu", **kw)
    # the stacked int8 weights K9b keeps in L2: ViT-S/16's 21.2 MB fits the gate
    assert bk.stacked_weight_bytes(qp_t["blocks"], 2) == 2 * (128 * 384 + 128 * 128
                                                              + 2 * 128 * 512)
    vit_s = 12 * (384 * 1152 + 384 * 384 + 2 * 384 * 1536)
    assert vit_s == 21_233_664 and vit_s <= bk.MEGAMODEL_RES_MAX_WEIGHT_BYTES
    vit_b = 12 * (768 * 2304 + 768 * 768 + 2 * 768 * 3072)
    assert vit_b > bk.MEGAMODEL_RES_MAX_WEIGHT_BYTES
    assert bk.megablock_shapes_ok(197, 6, 64, 1536) and bk.megablock_shapes_ok(197, 12, 64, 3072)
    assert bk.megablock_shapes_ok(901, 6, 64, 1536)  # ViT-S/16 at 480 px: K3 takes any N


# ---------------------------------------------------------------------------
# options, repairs, presets, raises
# ---------------------------------------------------------------------------

def test_fused_forms_as_in_jax(export):
    """``fused=False`` and ``"none"`` are the exact path, ``True`` is
    ``"pallas"``, ``"megamodel:BB:tight"`` (JAX's preset string) is the
    megamodel chain; make_int8_forward's and the predictor's options pass
    through."""
    _, tcfg, _, qp_t, x = export
    xt = torch.from_numpy(x)
    exact = int8_apply(qp_t, xt, tcfg)
    assert torch.equal(int8_apply(qp_t, xt, tcfg, fused=False), exact)
    assert torch.equal(make_int8_forward(tcfg, fused=False)(qp_t, xt), exact)
    bf = dict(attn_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    assert torch.equal(int8_apply(qp_t, xt, tcfg, fused=True, **bf),
                       int8_apply(qp_t, xt, tcfg, fused="pallas", **bf))
    chain = int8_apply(qp_t, xt, tcfg, fused="megamodel", **bf)
    for f in ("megamodel:4:tight", "megamodel:2", "megamodel_plain:4:tight"):
        assert torch.equal(int8_apply(qp_t, xt, tcfg, fused=f, **bf), chain)
    imgs = np.random.default_rng(3).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    pred = Int8Predictor(qp_t, tcfg, batch_size=4, device="cpu", fused="mixed_none",
                         attn_impl="pallas", use_pallas=True)
    assert pred.options["fused"] == "mixed_none" and pred.options["use_pallas"] is True
    assert pred.logits(imgs).shape == (3, 10)
    for bad in ("megamodel:x", "megablock:4:loose", "megamodel_res:4:tight:1", "mixed:4",
                "bogus"):
        with pytest.raises(ValueError):
            int8_apply(qp_t, xt, tcfg, fused=bad)
    with pytest.raises(ValueError, match="attn_impl"):
        int8_apply(qp_t, xt, tcfg, attn_impl="flash")


def test_raises_as_in_jax(export):
    """The activations the JAX package refuses in-kernel: a quick-GELU model
    on the whole-block kernels, any other activation on the chains whose
    fc1 epilogue computes it."""
    jcfg, tcfg, qp_np, qp_t, x = export
    jq, tq = dataclasses.replace(jcfg, act="quick_gelu"), dataclasses.replace(tcfg, act="quick_gelu")
    xt, xj, qj = torch.from_numpy(x), jnp.asarray(x), jax.tree.map(jnp.asarray, qp_np)
    for mode in ("megablock", "megamodel_res:2:tight"):
        with pytest.raises(NotImplementedError):
            jax_int8_apply(qj, xj, jq, fused=mode)
        with pytest.raises(NotImplementedError, match="mixed_none"):
            int8_apply(qp_t, xt, tq, fused=mode)
    jr, tr = dataclasses.replace(jcfg, act="relu"), dataclasses.replace(tcfg, act="relu")
    for mode in ("pallas", "mixed", "mixed_fc1"):
        with pytest.raises(NotImplementedError):
            jax_int8_apply(qj, xj, jr, fused=mode)
        with pytest.raises(NotImplementedError, match="in-kernel"):
            int8_apply(qp_t, xt, tr, fused=mode)


def test_preset_rungs_match_jax():
    """The port's rungs pick JAX's path (without its TPU padding and block
    options) for ViT-S and ViT-B GELU (megamodel), ViT-S quick-GELU
    (mixed_none + the fused attention), OWLv2-pruned (megamodel_long),
    577-token ViT-S (384 px: past JAX's batched-softmax budget, so
    mixed_none + the long attention, on JAX's conditions) and 901-token
    ViT-S (mixed_none + the long attention)."""
    from qat_vit_tpu.models.vit import ViTConfig as JaxViTConfig
    from qat_vit_tpu_torch.models.owlv2_detect import detector_config
    from qat_vit_tpu_torch.models.vit import ViTConfig

    cases = [dict(), dict(embed_dim=768, num_heads=12), dict(act="quick_gelu"),
             dict(image_size=384), dict(image_size=480)]
    for kw in cases:
        want = jax_preset_kernel_opts(JaxViTConfig(**kw))
        got = _preset_kernel_opts(ViTConfig(**kw))
        assert got["fused"] == want["fused"].split(":")[0], (kw, got, want)
        assert got.get("attn_impl") == want.get("attn_impl"), (kw, got, want)
    assert jax_preset_kernel_opts(JaxViTConfig(image_size=384))["fused"] == "mixed_none"
    assert _preset_kernel_opts(ViTConfig(image_size=384)) == {"fused": "mixed_none",
                                                              "attn_impl": "pallas_long"}
    pruned = detector_config(pruned=True)
    assert _preset_kernel_opts(pruned) == {"fused": "megamodel_long"}
    # width 576 is not lane-aligned: JAX's rung 4, on JAX's conditions
    assert _preset_kernel_opts(dataclasses.replace(pruned, image_size=224)) == {
        "fused": "mixed_none", "attn_impl": "pallas_long"}
