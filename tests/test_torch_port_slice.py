"""Port parity for the int8 serving slice as a whole, at micro size
(``vit_micro_test``: D 128, depth 2, 2 heads, hd 64, 32 px, 17 tokens).

- the port's ``model_forward`` (the K4 block chain, plain versions on the
  CPU) against JAX ``model_forward`` in Pallas interpret mode;
- the port's ``int8_apply`` (exact and megamodel) against JAX
  ``int8_apply`` on the same export, carried across by ``export_from_numpy``;
- preprocessing, the predictor, the serving preset's gates, and that the
  port imports with JAX blocked.
"""

import subprocess
import sys
import textwrap
from functools import partial

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from qat_vit_tpu.models.registry import create_model as jax_create_model
from qat_vit_tpu.models.vit import ViTConfig as JaxViTConfig
from qat_vit_tpu.ops.block_kernel import model_forward as jax_model_forward
from qat_vit_tpu.serve.int8_vit import _preset_kernel_opts as jax_preset_kernel_opts
from qat_vit_tpu.serve.int8_vit import convert_vit as jax_convert_vit
from qat_vit_tpu.serve.int8_vit import int8_apply as jax_int8_apply
from qat_vit_tpu_torch.data.pipeline import preprocess_fn, resize_matrix
from qat_vit_tpu_torch.models.jax_params import export_from_numpy
from qat_vit_tpu_torch.models.registry import create_model
from qat_vit_tpu_torch.ops import fused_serve as fs
from qat_vit_tpu_torch.ops.block_kernel import PLAIN_OPS, model_forward
from qat_vit_tpu_torch.serve.int8_vit import (
    _embed,
    _preset_kernel_opts,
    int8_apply,
    serving_preset,
)
from qat_vit_tpu_torch.serve.predictor import Int8Predictor


def _jax_interpret(fn, *args):
    """One jitted call under the Mosaic-TPU interpreter (see the deadlock
    note on ``interpret_apply`` in tests/test_fused_serve.py)."""
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
    return out


@pytest.fixture(scope="module")
def export():
    """A JAX micro export (params + observed stats), as numpy and as the port's tree."""
    jm = jax_create_model("vit_micro_test", qat_wrapper=True)
    v = nn.meta.unbox(jm.module.init(jax.random.key(0), jm.example_input(1), observe=False))
    x = np.random.default_rng(0).normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    _, mut = jm.module.apply({"params": v["params"], "quant_stats": v["quant_stats"]},
                             jnp.asarray(x), observe=True, mutable=["quant_stats"])
    qp_np = jax.device_get(jax_convert_vit(v["params"], mut["quant_stats"], jm.cfg))
    tm = create_model("vit_micro_test", qat_wrapper=True)
    return jm.cfg, tm.cfg, qp_np, export_from_numpy(qp_np), x


def _int8_close(got, want, min_exact=0.999):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= min_exact, (diff == 0).mean()


def test_model_forward_matches_jax_interpret(export):
    """K4's per-block contract: the same (zq, x) in, the same (x', zq') out.
    The sequence is padded 17 → 32 for the TPU kernel; padded keys are
    masked and padded rows dropped. Integer GEMMs are exact in both; LN and
    softmax sums differ in order, so x' (bf16) agrees to a few bf16 ulps and
    zq' within ±1 with >= 99.9% exact."""
    jcfg, tcfg, qp_np, qp_t, x_img = export
    with torch.no_grad():
        x = _embed(qp_t, torch.from_numpy(x_img[:4]), tcfg, torch.bfloat16, PLAIN_OPS.int8_dense)
    n = x.shape[1]
    x = torch.cat([x, torch.zeros(x.shape[0], 32 - n, x.shape[2], dtype=x.dtype)], dim=1)
    blk0 = qp_t["blocks"]["0"]
    zq = fs.ln_quantize(x, blk0["norm1"], blk0["norm1"]["out_q"])
    x_out, zq_out = model_forward(zq, x, qp_t["blocks"], qp_t["norm"], num_heads=2,
                                  head_dim=64, depth=2, n_valid=n)
    jx, jzq = _jax_interpret(
        partial(jax_model_forward, num_heads=2, head_dim=64, depth=2, n_valid=n, block_b=2),
        jnp.asarray(zq.numpy()), jnp.asarray(x.float().numpy(), jnp.bfloat16),
        qp_np["blocks"], qp_np["norm"],
    )
    _int8_close(zq_out[:, :n].numpy(), np.asarray(jzq)[:, :n])
    np.testing.assert_allclose(x_out[:, :n].float().numpy(),
                               np.asarray(jx[:, :n], np.float32), rtol=2e-2, atol=2e-2)


def test_int8_apply_exact_matches_jax(export):
    """The exact path (f32 stream, erf-GELU, divide-quantize, exact integer
    GEMMs) on the same export: f32 summation order only, through two int8
    blocks; logits agree to 1e-3 and the argmax everywhere."""
    jcfg, tcfg, qp_np, qp_t, x = export
    want = np.asarray(jax_int8_apply(jax.tree.map(jnp.asarray, qp_np), jnp.asarray(x), jcfg))
    got = int8_apply(qp_t, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_int8_apply_megamodel_matches_jax(export):
    """The megamodel path: JAX's Pallas stack in interpret mode vs the port's
    K4 launch chain (plain versions on the CPU), both bf16 stream +
    tanh-GELU. The entry LN quantizes by multiplication in the port and by
    division in JAX, and LN/softmax sums differ in order: a few int8
    elements may flip by one, so logits agree to 2e-2."""
    jcfg, tcfg, qp_np, qp_t, x = export
    want = np.asarray(_jax_interpret(
        partial(jax_int8_apply, cfg=jcfg, compute_dtype=jnp.bfloat16, fused="megamodel:2:tight"),
        jax.tree.map(jnp.asarray, qp_np), jnp.asarray(x)))
    got = int8_apply(qp_t, torch.from_numpy(x), tcfg, compute_dtype=torch.bfloat16,
                     fused="megamodel").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    # the plain chain is the same arithmetic as the kernel chain
    plain = int8_apply(qp_t, torch.from_numpy(x), tcfg, compute_dtype=torch.bfloat16,
                       fused="megamodel_plain").numpy()
    np.testing.assert_array_equal(plain, got)


def test_preprocess_matches_jax():
    """The numpy-built bicubic matrix (Keys a = -0.5, half-pixel centres,
    in-range renormalization; built in f64) against jax.image.resize's f32
    one to 1e-5, and the whole preprocess: that matrix difference, summed
    over taps of pixels <= 1 and divided by std >= 0.224, bounds it by 5e-5."""
    from qat_vit_tpu.data.pipeline import _resize_matrix, preprocess_fn as jax_preprocess_fn

    np.testing.assert_allclose(resize_matrix(32, 224), np.asarray(_resize_matrix(32, 224)),
                               rtol=0, atol=1e-5)
    imgs = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(jax_preprocess_fn(224)(jnp.asarray(imgs)))
    got = preprocess_fn(224)(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_predictor_cpu(export):
    """Padding to the static batch, chunking, streaming: the same logits as
    one int8_apply call over the preprocessed images (the exact path on
    CPU), up to f32 BLAS blocking that may change with the batch size."""
    _, tcfg, _, qp_t, _ = export
    imgs = np.random.default_rng(2).integers(0, 256, (7, 32, 32, 3), dtype=np.uint8)
    pred = Int8Predictor(qp_t, tcfg, batch_size=3, device="cpu")
    assert pred.options == {"attn_dtype": torch.bfloat16, "compute_dtype": torch.bfloat16}
    logits = pred.logits(imgs)
    assert logits.shape == (7, 10) and np.isfinite(logits).all()
    want = int8_apply(qp_t, preprocess_fn(32)(torch.from_numpy(imgs)), tcfg,
                      attn_dtype=torch.bfloat16, compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pred.predict(imgs), logits.argmax(-1))
    streamed = list(pred.serve_stream([imgs[:2], imgs[2:7], imgs[6:]]))
    assert [len(s) for s in streamed] == [2, 5, 1]
    np.testing.assert_array_equal(np.concatenate(streamed[:2]), logits)
    with pytest.raises(NotImplementedError):
        Int8Predictor(qp_t, tcfg, mesh=object())
    if not torch.cuda.is_available():  # the card is the default: no fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Int8Predictor(qp_t, tcfg)


def test_serving_preset_gates():
    """CPU: the exact defaults. CUDA: JAX's rungs under the Hopper gates:
    the megamodel chain for GELU ViTs the kernels accept, mixed_none + K3
    for other models within attention_q's gate, the megamodel_long chain
    for 2,305-token ones, mixed_none + K5a for sequences between;
    geometries no kernel gate of either package admits get ``{}``, the exact
    path in bf16, as in JAX; 10,001-token ViT-S takes JAX's rung there."""
    import dataclasses

    from qat_vit_tpu_torch.models.vit import ViTConfig

    vit_s = ViTConfig()
    assert serving_preset(vit_s, "cpu") == {}
    assert _preset_kernel_opts(vit_s) == {"fused": "megamodel"}
    assert _preset_kernel_opts(ViTConfig(embed_dim=768, num_heads=12)) == {"fused": "megamodel"}
    assert _preset_kernel_opts(ViTConfig(embed_dim=128, depth=2, num_heads=2, image_size=32,
                                         patch_size=8)) == {"fused": "megamodel"}
    assert _preset_kernel_opts(dataclasses.replace(vit_s, image_size=768)) == {
        "fused": "megamodel_long"}  # 2305 tokens: K6
    mixed_k3 = {"fused": "mixed_none", "attn_impl": "pallas_fused"}
    assert _preset_kernel_opts(dataclasses.replace(vit_s, act="quick_gelu")) == mixed_k3
    # width 96 is not lane-aligned: JAX's rung 4, on JAX's conditions
    assert _preset_kernel_opts(ViTConfig(embed_dim=96, num_heads=3)) == {
        "fused": "mixed_none", "attn_impl": "pallas_long"} == jax_preset_kernel_opts(
        JaxViTConfig(embed_dim=96, num_heads=3))
    # 901 tokens: over attention_q's gate, under the K6 rung
    assert _preset_kernel_opts(dataclasses.replace(vit_s, image_size=480)) == {
        "fused": "mixed_none", "attn_impl": "pallas_long"}
    # hd 60: no attention kernel in either package
    past = ViTConfig(embed_dim=360, num_heads=6)
    assert _preset_kernel_opts(past) == {} == jax_preset_kernel_opts(
        JaxViTConfig(embed_dim=360, num_heads=6))
    assert serving_preset(past, "cuda") == {"attn_dtype": torch.bfloat16,
                                            "compute_dtype": torch.bfloat16,
                                            "gelu_approx": True}
    # 10,001 tokens: JAX's rung 4 (its long attention; its whole-model kernel's
    # working set does not fit), which the streaming kernels serve at any N
    long_k5a = {"fused": "mixed_none", "attn_impl": "pallas_long"}
    assert jax_preset_kernel_opts(JaxViTConfig(image_size=1600)) == long_k5a
    assert _preset_kernel_opts(dataclasses.replace(vit_s, image_size=1600)) == long_k5a


def test_port_imports_without_jax():
    """The port never imports jax, flax or qat_vit_tpu (nor pyyaml, msgpack
    or ml_dtypes, which the card's machine may lack: the port's checkpoints
    go through its own msgpack codec), and importing it builds nothing and
    does not initialize CUDA."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        sys.modules["yaml"] = None
        sys.modules["msgpack"] = None
        sys.modules["ml_dtypes"] = None
        import importlib, pkgutil
        import qat_vit_tpu_torch
        for m in pkgutil.walk_packages(qat_vit_tpu_torch.__path__, "qat_vit_tpu_torch."):
            importlib.import_module(m.name)
        import torch
        from qat_vit_tpu_torch import _build
        from qat_vit_tpu_torch.utils.msgpack_codec import packb, unpackb
        tree = {"w": torch.ones(2, 3, dtype=torch.bfloat16), "b": [1.5, None]}
        back = unpackb(packb(tree))
        assert torch.equal(back["w"], tree["w"]) and packb(back) == packb(tree)
        assert _build._library is None
        assert not torch.cuda.is_initialized()
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "qat_vit_tpu",
                                                              "msgpack", "ml_dtypes")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
