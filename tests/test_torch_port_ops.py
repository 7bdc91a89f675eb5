"""Port parity: the plain versions of the Hopper kernels' ops against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
``tests/test_fused_serve.py::TestFusedDense`` runs them.

On the CPU every port wrapper takes its plain version, so these tests hold
the arithmetic the CUDA kernels implement (``chip_smoke.py`` holds each
kernel against that same plain version on the card).

Tolerances: the integer GEMM is exact in both packages; float epilogues
run the same f32 operations, but reductions (LN mean/var, softmax sums,
the score dots) take another summation order, and tanh/exp differ in the
last ulp. So float outputs agree to ~1e-6 relative, and an int8 output
may flip by one at a rounding boundary: every element within ±1, at least
99.9% exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qat_vit_tpu.ops import fused_serve as jfs
from qat_vit_tpu.ops.flash_attention import fused_attention_qkv as jax_fused_attention
from qat_vit_tpu.ops.flash_attention import xla_attention_qkv as jax_xla_attention
from qat_vit_tpu.ops.quantized_matmul import int8_matmul_xla, quantize_act_shifted as jqa
from qat_vit_tpu_torch.ops import fused_serve as fs
from qat_vit_tpu_torch.ops.flash_attention import (
    attention_fwd_shapes_ok,
    fused_attention_qkv,
    xla_attention_qkv,
)
from qat_vit_tpu_torch.ops.quantized_matmul import int8_matmul, quantize_act_shifted

M, K, N = 150, 128, 256  # M is not a multiple of the JAX kernel's 256-row tile


def _int8_close(got, want, min_exact=0.999):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= min_exact, (diff == 0).mean()


def _both(tree):
    """numpy tree → (jax tree, torch tree)."""
    j = {k: (jnp.asarray(v) if v is not None else None) for k, v in tree.items()}
    t = {k: (torch.from_numpy(np.asarray(v)) if v is not None else None) for k, v in tree.items()}
    return j, t


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x_q = rng.integers(-128, 128, (M, K), dtype=np.int8)
    w = np.clip(np.round(rng.normal(0, 20, (K, N))), -128, 127).astype(np.int8)
    layer = {"w_int8": w, "w_colsum": w.astype(np.int32).sum(0, dtype=np.int32),
             "bias": rng.normal(0, 0.5, N).astype(np.float32), "w_scale": np.float32(0.002)}
    q = {"in": {"scale": np.float32(0.02), "zero_point": np.float32(121.0)},
         "out": {"scale": np.float32(0.03), "zero_point": np.float32(128.0)},
         "gelu": {"scale": np.float32(0.015), "zero_point": np.float32(11.0)}}
    ln = {"scale": rng.normal(1, 0.2, N).astype(np.float32),
          "bias": rng.normal(0, 0.2, N).astype(np.float32)}
    res = rng.normal(0, 1.5, (M, N)).astype(np.float32)
    return x_q, layer, q, ln, res


def test_quantize_and_int8_matmul_match_xla(case):
    x_q, layer, q, _, _ = case
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (M, K)).astype(np.float32)
    jq = jqa(jnp.asarray(x), q["in"]["scale"], q["in"]["zero_point"])
    tq = quantize_act_shifted(torch.from_numpy(x), q["in"]["scale"], q["in"]["zero_point"])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    jl, tl = _both(layer)
    want = int8_matmul_xla(jnp.asarray(x_q), jl["w_int8"], x_scale=q["in"]["scale"],
                           x_zero_point=q["in"]["zero_point"], w_scale=jl["w_scale"],
                           w_colsum=jl["w_colsum"], bias=jl["bias"])
    got = int8_matmul(torch.from_numpy(x_q), tl["w_int8"], x_scale=q["in"]["scale"],
                      x_zero_point=q["in"]["zero_point"], w_scale=tl["w_scale"],
                      w_colsum=tl["w_colsum"], bias=tl["bias"])
    # identical f32 ops on an exact integer accumulator
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("per_channel", [False, True])
def test_int8_dense_matches_pallas(case, per_channel):
    x_q, layer, q, _, _ = case
    layer = dict(layer)
    if per_channel:
        layer["w_scale"] = np.random.default_rng(2).uniform(1e-3, 3e-3, N).astype(np.float32)
    jl, tl = _both(layer)
    want = jfs.int8_dense(jnp.asarray(x_q), jl, q["in"], out_dtype=jnp.float32, tile_m=256,
                          interpret=True)
    got = fs.int8_dense(torch.from_numpy(x_q), tl, q["in"], out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_int8_dense_gelu_q_matches_pallas(case, act):
    x_q, layer, q, _, _ = case
    jl, tl = _both(layer)
    want = jfs.int8_dense_gelu_q(jnp.asarray(x_q), jl, q["in"], q["gelu"], act=act,
                                 tile_m=256, interpret=True)
    got = fs.int8_dense_gelu_q(torch.from_numpy(x_q), tl, q["in"], q["gelu"], act=act)
    _int8_close(got.numpy(), want)


@pytest.mark.parametrize("qmax", [255.0, 127.0])
def test_int8_dense_resid_ln_q_matches_pallas(case, qmax):
    x_q, layer, q, ln, res = case
    jl, tl = _both(layer)
    y_j, q_j = jfs.int8_dense_resid_ln_q(
        jnp.asarray(x_q), jl, q["in"], jnp.asarray(res), ln, q["out"], out_dtype=jnp.float32,
        tile_m=256, quant_max=qmax, interpret=True)
    y_t, q_t = fs.int8_dense_resid_ln_q(
        torch.from_numpy(x_q), tl, q["in"], torch.from_numpy(res),
        {k: torch.from_numpy(v) for k, v in ln.items()}, q["out"], out_dtype=torch.float32,
        quant_max=qmax)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6, atol=1e-6)
    _int8_close(q_t.numpy(), q_j)
    assert q_t.numpy().max() <= qmax - 128


# K2d's widths: the case's N 256, then ViT-S/B/L's and OWLv2's widths, an odd
# width and one past the register form's plan (tests/test_torch_port_k2d.py)
LN_CASES = [pytest.param(dt, None, id=dt) for dt in ("float32", "bfloat16")] + [
    pytest.param(dt, n, id=f"{dt}-{n}") for n in (384, 576, 768, 1024, 385, 1280)
    for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("dtype,n", LN_CASES)
def test_ln_quantize_matches_pallas(case, dtype, n):
    _, _, q, ln, res = case
    if n is not None:
        r = np.random.default_rng(n)
        res = r.normal(0.3, 1.5, (M, n)).astype(np.float32)
        ln = {"scale": r.normal(1, 0.2, n).astype(np.float32),
              "bias": r.normal(0, 0.2, n).astype(np.float32)}
    x_j = jnp.asarray(res).astype(dtype)
    x_t = torch.from_numpy(res).to(getattr(torch, dtype))
    want = jfs.ln_quantize(x_j, ln, q["out"], tile_m=256, interpret=True)
    got = fs.ln_quantize(x_t, {k: torch.from_numpy(v) for k, v in ln.items()}, q["out"])
    _int8_close(got.numpy(), want)


@pytest.mark.parametrize("heads,n", [(2, 17), (6, 197)])
def test_fused_attention_qkv_out_q_matches_pallas(heads, n):
    """K3 with quantize=True (bf16 qkv), micro and ViT-S head geometry."""
    hd, b = 64, 2
    rng = np.random.default_rng(3)
    qkv = rng.normal(0, 1.0, (b, n, 3 * heads * hd)).astype(np.float32)
    out_q = {"scale": np.float32(4.0 / 255), "zero_point": np.float32(128.0)}
    want = jax_fused_attention(jnp.asarray(qkv, jnp.bfloat16), heads, hd, block_b=2,
                               out_q=out_q, interpret=True)
    got = fused_attention_qkv(torch.from_numpy(qkv).to(torch.bfloat16), heads, hd, out_q=out_q)
    _int8_close(got.numpy(), want)


def test_fused_attention_masks_padded_keys():
    """Rows padded past n_valid do not change the valid rows' output."""
    heads, hd, n, pad = 2, 64, 17, 15
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(0, 1, (2, n, 3 * heads * hd)).astype(np.float32))
    padded = torch.cat([qkv, torch.from_numpy(
        rng.normal(0, 5, (2, pad, 3 * heads * hd)).astype(np.float32))], dim=1)
    out_q = {"scale": 4.0 / 255, "zero_point": 128.0}
    a = fused_attention_qkv(qkv.to(torch.bfloat16), heads, hd, out_q=out_q)
    b = fused_attention_qkv(padded.to(torch.bfloat16), heads, hd, out_q=out_q, n_valid=n)
    _int8_close(b[:, :n].numpy(), a.numpy())


def test_xla_attention_matches_jax():
    heads, hd, n = 2, 64, 17
    qkv = np.random.default_rng(5).normal(0, 1, (2, n, 3 * heads * hd)).astype(np.float32)
    want = jax_xla_attention(jnp.asarray(qkv), heads, hd)
    got = xla_attention_qkv(torch.from_numpy(qkv), heads, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_kernel_gates():
    assert attention_fwd_shapes_ok(197, 64) and attention_fwd_shapes_ok(17, 64)
    assert attention_fwd_shapes_ok(2305, 64)  # any N (OWLv2's serving takes K6 by length)
    assert not attention_fwd_shapes_ok(197, 60) and not attention_fwd_shapes_ok(197, 256)
    assert fs.gemm_shapes_ok(384, 1152) and fs.gemm_shapes_ok(1536, 384, resid_ln=True)
    assert fs.gemm_shapes_ok(384, 10)  # the head's ragged N
    assert not fs.gemm_shapes_ok(100, 384)
    # without out_q: the float-output form (kernel A; its plain version here)
    out = fused_attention_qkv(torch.zeros(1, 4, 3 * 64, dtype=torch.bfloat16), 1, 64)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 4, 64)
