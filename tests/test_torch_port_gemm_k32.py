"""The int8 GEMMs at K = 32 (mod 64), the packed weights and the GEMM gates.

JAX's gates take K a multiple of 32 (``fused_serve.py:375-378``,
``pallas_gemm.py:37-48``); the port's int8_gemm kernels and K7 take K a
multiple of 16 (their 16-byte rows, zero-filled past K). Here, at K 96 and
480 with the same numpy-seeded inputs:

- the plain versions of K2a (PLAIN), K2b (GELU_Q), K2c (RESID_LN_Q) and K7
  against JAX's Pallas kernels in interpret mode (the integer product is
  exact in both; the float epilogues as in ``tests/test_torch_port_ops.py``:
  f32 within 1e-6, int8 within one step and >= 99.9% identical);
- ``pack_gemm_weights`` (``export_to_device`` on a CUDA device) gives every
  GEMM layer its k-contiguous ``w_int8_t`` and leaves ``w_int8`` as it was;
- what the wrappers hand ``qvt_int8_gemm`` (a recording stand-in for the
  kernel library), and that they raise without the packed weight;
- ``gemm_shapes_ok`` at K % 16, K9's gate still at K % 64, and the patch
  embedding routed by its shape (K 588 at patch 14: the plain product).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from qat_vit_tpu.ops import fused_serve as jfs
from qat_vit_tpu.ops import pallas_gemm as jax_pallas_gemm
from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.models.vit import ViTConfig
from qat_vit_tpu_torch.ops import block_kernel as bk
from qat_vit_tpu_torch.ops import fused_serve as fs
from qat_vit_tpu_torch.ops.pallas_gemm import fused_quantize_matmul, fused_quantize_matmul_available
from qat_vit_tpu_torch.serve import int8_vit


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


M = 150  # not a multiple of the JAX kernels' 256-row tile
IN_Q = {"scale": np.float32(0.02), "zero_point": np.float32(121.0)}
OUT_Q = {"scale": np.float32(0.03), "zero_point": np.float32(128.0)}
GELU_Q = {"scale": np.float32(0.015), "zero_point": np.float32(11.0)}


def _int8_close(got, want, min_exact=0.999):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff == 0).mean() >= min_exact, (diff.max(), (diff == 0).mean())


def _case(k, n, per_channel=False, seed=0):
    """x_q [M, k], a layer (numpy) and its JAX and torch trees."""
    rng = np.random.default_rng(seed + k + n)
    x_q = rng.integers(-128, 128, (M, k), dtype=np.int8)
    w = np.clip(np.round(rng.normal(0, 20, (k, n))), -128, 127).astype(np.int8)
    ws = rng.uniform(1e-3, 3e-3, n).astype(np.float32) if per_channel else np.float32(0.002)
    layer = {"w_int8": w, "w_colsum": w.astype(np.int32).sum(0, dtype=np.int32),
             "bias": rng.normal(0, 0.5, n).astype(np.float32), "w_scale": ws}
    jl = {key: jnp.asarray(v) for key, v in layer.items()}
    tl = {key: torch.from_numpy(np.asarray(v)) for key, v in layer.items()}
    return rng, x_q, jl, tl


@pytest.mark.parametrize("k,per_channel", [(96, False), (480, True)])
def test_plain_dense_matches_jax(k, per_channel):
    """K2a's plain version against JAX's ``_plain_kernel`` at K 96 and 480."""
    _, x_q, jl, tl = _case(k, 256, per_channel)
    want = jfs.int8_dense(jnp.asarray(x_q), jl, IN_Q, out_dtype=jnp.float32, tile_m=256,
                          interpret=True)
    got = fs.int8_dense(torch.from_numpy(x_q), tl, IN_Q, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,act", [(96, "gelu"), (480, "quick_gelu")])
def test_gelu_q_matches_jax(k, act):
    """K2b's plain version against JAX's ``_gelu_q_kernel`` at K 96 and 480."""
    _, x_q, jl, tl = _case(k, 256)
    want = jfs.int8_dense_gelu_q(jnp.asarray(x_q), jl, IN_Q, GELU_Q, act=act, tile_m=256,
                                 interpret=True)
    got = fs.int8_dense_gelu_q(torch.from_numpy(x_q), tl, IN_Q, GELU_Q, act=act)
    _int8_close(got.numpy(), want)


@pytest.mark.parametrize("k", [96, 480])
def test_resid_ln_q_matches_jax(k):
    """K2c's plain version against JAX's ``_resid_ln_q_kernel`` at K 96 and 480."""
    rng, x_q, jl, tl = _case(k, 256)
    res = rng.normal(0, 1.5, (M, 256)).astype(np.float32)
    ln = {"scale": rng.normal(1, 0.2, 256).astype(np.float32),
          "bias": rng.normal(0, 0.2, 256).astype(np.float32)}
    y_j, q_j = jfs.int8_dense_resid_ln_q(jnp.asarray(x_q), jl, IN_Q, jnp.asarray(res), ln, OUT_Q,
                                         out_dtype=jnp.float32, tile_m=256, interpret=True)
    y_t, q_t = fs.int8_dense_resid_ln_q(torch.from_numpy(x_q), tl, IN_Q, torch.from_numpy(res),
                                        {key: torch.from_numpy(v) for key, v in ln.items()},
                                        OUT_Q, out_dtype=torch.float32)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6, atol=1e-6)
    _int8_close(q_t.numpy(), q_j)


@pytest.mark.parametrize("k", [96, 480])
def test_fused_quantize_matmul_matches_jax(k):
    """K7's plain version against JAX's ``pallas_gemm`` kernel at K 96 and
    480, shapes JAX's gate admits (XLA on the CPU contracts the dequant into
    an FMA: 1e-6 rel, as in tests/test_torch_port_serve_modes.py)."""
    rng = np.random.default_rng(k)
    x = rng.normal(0, 1.5, (M, k)).astype(np.float32)
    w = np.clip(np.round(rng.normal(0, 20, (k, 128))), -128, 127).astype(np.int8)
    colsum, bias = w.astype(np.int32).sum(0, dtype=np.int32), rng.normal(0, 0.5, 128).astype(np.float32)
    assert fused_quantize_matmul_available(x.shape, w.shape)
    s_x, zp = np.float32(4.0 / 255), np.float32(100.0)
    want = jax_pallas_gemm.fused_quantize_matmul(
        jnp.asarray(x), jnp.asarray(w), x_scale=s_x, x_zero_point=zp, w_scale=np.float32(0.002),
        w_colsum=jnp.asarray(colsum), bias=jnp.asarray(bias), interpret=True)
    got = fused_quantize_matmul(torch.from_numpy(x), torch.from_numpy(w), x_scale=torch.tensor(s_x),
                                x_zero_point=torch.tensor(zp), w_scale=torch.tensor(np.float32(0.002)),
                                w_colsum=torch.from_numpy(colsum), bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def _export(depth=2, d=96, mlp=384, classes=10, k_patch=192):
    rng = np.random.default_rng(7)

    def layer(k, n):
        w = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
        return {"w_int8": w, "w_colsum": w.to(torch.int32).sum(0), "w_scale": torch.tensor(0.002),
                "bias": torch.zeros(n), "out_q": {"scale": torch.tensor(0.1),
                                                 "zero_point": torch.tensor(128.0)}}

    ln = {"scale": torch.ones(d), "bias": torch.zeros(d),
          "out_q": {"scale": torch.tensor(0.1), "zero_point": torch.tensor(128.0)}}
    blocks = {str(i): {"norm1": ln, "qkv": layer(d, 3 * d), "proj": layer(d, d), "norm2": ln,
                       "fc1": layer(d, mlp), "gelu_q": {"scale": torch.tensor(0.1),
                                                        "zero_point": torch.tensor(10.0)},
                       "fc2": layer(mlp, d)} for i in range(depth)}
    return {"patch_embed": layer(k_patch, d), "head": layer(d, classes), "norm": ln,
            "blocks": blocks, "input_q": {"scale": torch.tensor(0.05),
                                          "zero_point": torch.tensor(128.0)}}


def test_every_gemm_layer_packed():
    """``pack_gemm_weights`` gives every GEMM layer (qkv, proj, fc1, fc2, the
    patch embedding, the head) ``w_int8_t``, the k-contiguous transpose of
    ``w_int8``, and leaves every other entry, ``w_int8`` included, as it was;
    nested trees (a detector's ``tower``) too, and nothing without a
    ``w_int8``."""
    src = _export()
    packed = int8_vit.pack_gemm_weights({"tower": src, "heads": {"w": torch.ones(3)}})
    assert packed["heads"] == {"w": packed["heads"]["w"]} and "w_int8_t" not in packed["heads"]
    tower = packed["tower"]
    layers = [(tower["patch_embed"], src["patch_embed"]), (tower["head"], src["head"])]
    layers += [(tower["blocks"][i][g], src["blocks"][i][g])
               for i in src["blocks"] for g in ("qkv", "proj", "fc1", "fc2")]
    for got, want in layers:
        assert set(got) == set(want) | {"w_int8_t"}
        assert got["w_int8"] is want["w_int8"] and "w_int8_t" not in want
        t = got["w_int8_t"]
        assert t.is_contiguous() and t.dtype == torch.int8
        np.testing.assert_array_equal(t.numpy(), np.ascontiguousarray(want["w_int8"].numpy().T))
    for i in src["blocks"]:
        for g in ("norm1", "norm2", "gelu_q"):
            assert "w_int8_t" not in tower["blocks"][i][g]
    assert "w_int8_t" not in tower["norm"]
    on_cpu = int8_vit.export_to_device(src, "cpu")  # packed on a CUDA device only
    assert "w_int8_t" not in on_cpu["patch_embed"] and "w_int8_t" not in on_cpu["blocks"]["0"]["qkv"]


def test_gemm_gates():
    """int8_gemm (K2a, K2b, K2c) takes K a multiple of 16 (so every K % 32
    that JAX's gates take), any N (RESID_LN_Q up to its shared-memory plan);
    K9 takes what the chain's kernels take."""
    assert fs.GEMM_K_MULTIPLE == 16
    for k in (16, 32, 96, 480, 576, 588, 100, 8, 24):
        assert fs.gemm_shapes_ok(k, 384) == (k % 16 == 0), k
        assert fs.gemm_shapes_ok(k, 384, resid_ln=True) == (k % 16 == 0), k
    assert fs.gemm_shapes_ok(96, 10) and not fs.gemm_shapes_ok(0, 10)
    assert not fs.gemm_shapes_ok(96, fs.RESID_LN_MAX_N + 1, resid_ln=True)
    # K9: the chain kernels' gates, so widths 480 and 96 (K % 64 = 32) too
    assert bk.megablock_shapes_ok(197, 6, 64, 1536) and bk.megablock_shapes_ok(197, 12, 64, 3072)
    assert bk.megablock_shapes_ok(197, 5, 96, 1920)
    assert bk.megablock_shapes_ok(197, 3, 32, 384)
    assert bk.megablock_shapes_ok(197, 6, 64, 1568)  # fc2's K % 64 = 32
    assert bk.megablock_shapes_ok(2305, 6, 64, 1536)  # K3 takes any N
    assert not bk.megablock_shapes_ok(197, 6, 64, 1544)  # fc2's K % 16 = 8


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


def test_launch_arguments(recorder):
    """PLAIN, PLAIN_Q8 and GELU_Q launch ``qvt_int8_gemm`` with the packed
    weight, the epilogue, the output pointers and types, K % 64 = 32 as it
    is; one launch per call; a layer without ``w_int8_t`` raises before any
    launch."""
    _, x_q, _, tl = _case(480, 1440, per_channel=True)
    x = torch.from_numpy(x_q)
    layer = fs.with_packed_weight(tl)
    counts = (fs.int8_dense.launches, fs.int8_dense_q8.launches, fs.int8_dense_gelu_q.launches)
    y = fs.int8_dense(x, layer, IN_Q)
    name, args = recorder.calls[-1]
    assert name == "qvt_int8_gemm" and y.dtype == torch.bfloat16 and y.shape == (M, 1440)
    assert args[:7] == (x.data_ptr(), layer["w_int8_t"].data_ptr(), layer["w_colsum"].data_ptr(),
                        layer["bias"].data_ptr(), layer["w_scale"].data_ptr(), y.data_ptr(), None)
    assert args[7:14] == (M, 1440, 480, fs.EPI_PLAIN, 1, 1, 0)
    assert args[14:17] == (0.0, float(np.float32(0.02)), 121 - 128)
    assert args[20:] == (1440, 0)
    y, q = fs.int8_dense_q8(x, layer, IN_Q, OUT_Q)
    name, args = recorder.calls[-1]
    assert args[5:7] == (y.data_ptr(), q.data_ptr()) and q.shape == (M, 960)
    assert args[7:14] == (M, 1440, 480, fs.EPI_PLAIN_Q8, 1, 1, 0)
    assert args[17:21] == (fs.inv_scale(OUT_Q["scale"]), 128.0, 255.0, 960)
    q = fs.int8_dense_gelu_q(x, layer, IN_Q, GELU_Q, act="quick_gelu", quant_max=127.0)
    name, args = recorder.calls[-1]
    assert args[5:7] == (None, q.data_ptr()) and q.dtype == torch.int8
    assert args[7:14] == (M, 1440, 480, fs.EPI_GELU_Q, 0, 1, 1)
    assert args[17:21] == (fs.inv_scale(GELU_Q["scale"]), 11.0, 127.0, 1440)
    calls = len(recorder.calls)
    bare = {key: v for key, v in layer.items() if key != "w_int8_t"}
    for fn, extra in ((fs.int8_dense, ()), (fs.int8_dense_q8, (OUT_Q,)),
                      (fs.int8_dense_gelu_q, (GELU_Q,))):
        with pytest.raises(ValueError, match="w_int8_t"):
            fn(x, bare, IN_Q, *extra)
    with pytest.raises(ValueError, match="unsupported K"):
        _, x2, _, t2 = _case(100, 128)
        fs.int8_dense(torch.from_numpy(x2), fs.with_packed_weight(t2), IN_Q)
    assert len(recorder.calls) == calls
    assert (fs.int8_dense.launches, fs.int8_dense_q8.launches,
            fs.int8_dense_gelu_q.launches) == tuple(c + 1 for c in counts)


@pytest.mark.parametrize("patch,routed", [(8, "dense"), (14, "plain")])
def test_patch_embedding_routed_by_shape(patch, routed):
    """``_embed`` sends the patch GEMM to the serving path's ``dense`` where
    int8_gemm takes its K = 3 p^2 (p 8: 192) and to the plain int8 product
    where it does not (p 14: 588), as JAX computes it in XLA on every path;
    the result is the plain product's either way."""
    cfg = ViTConfig(embed_dim=96, depth=1, num_heads=3, image_size=2 * patch, patch_size=patch)
    qp = _export(depth=1, k_patch=3 * patch * patch)
    qp["cls_token"] = torch.zeros(1, 1, 96)
    qp["pos_embed"] = torch.zeros(1, 5, 96)
    calls = []

    def dense(x_q, layer, in_q, out_dtype=torch.float32):
        calls.append(tuple(x_q.shape))
        return fs.int8_dense_plain(x_q, layer, in_q, out_dtype=out_dtype)

    images = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (2, 2 * patch, 2 * patch, 3)).astype(np.float32))
    got = int8_vit._embed(qp, images, cfg, torch.float32, dense)
    want = int8_vit._embed(qp, images, cfg, torch.float32, fs.int8_dense_plain)
    assert torch.equal(got, want) and got.shape == (2, 5, 96)
    assert calls == ([(2, 4, 3 * patch * patch)] if routed == "dense" else [])
