"""The port's Hopper kernels against their plain versions, on the card.

Marked ``requires_cuda``; each test skips without a CUDA device. The
machine with the card has no JAX, so run this file without the suite's
conftest::

    python -m pytest --noconftest -m requires_cuda tests/test_torch_port_cuda.py -q

Every kernel pins its roundings to its plain version (f64 LN and softmax
sums, index-ordered f32 dots), so outputs must be IDENTICAL, int8 and float.
"""

import numpy as np
import pytest
import torch

from qat_vit_tpu_torch.ops import fused_serve as fs
from qat_vit_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.requires_cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are sm_90a CUDA with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(rng, k, n, dev, per_channel=False):
    w = np.clip(np.round(rng.normal(0, 20, (k, n))), -128, 127).astype(np.int8)
    return {
        "w_int8": torch.from_numpy(w).to(dev),
        "w_colsum": torch.from_numpy(w.astype(np.int32).sum(0, dtype=np.int32)).to(dev),
        "bias": torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)).to(dev),
        "w_scale": (torch.from_numpy(rng.uniform(1e-3, 3e-3, n).astype(np.float32)).to(dev)
                    if per_channel else torch.tensor(0.002)),
    }


def _ln(rng, n, dev):
    return {"scale": torch.from_numpy(rng.normal(1, 0.2, n).astype(np.float32)).to(dev),
            "bias": torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32)).to(dev)}


IN_Q = {"scale": torch.tensor(0.02), "zero_point": torch.tensor(121.0)}
OUT_Q = {"scale": torch.tensor(8.0 / 255), "zero_point": torch.tensor(128.0)}


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), (x.float() - y.float()).abs().max()


@pytest.mark.parametrize("m,k,n,per_channel,out", [
    (6304, 384, 1152, False, "bf16"), (6272, 768, 384, False, "bf16"),
    (32, 384, 10, True, "f32"), (37, 128, 384, False, "f32"),
])
def test_int8_dense(dev, m, k, n, per_channel, out):
    rng = np.random.default_rng(m + n)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to(dev)
    layer = _layer(rng, k, n, dev, per_channel)
    dt = torch.bfloat16 if out == "bf16" else torch.float32
    _same(fs.int8_dense(x, layer, IN_Q, out_dtype=dt),
          fs.int8_dense_plain(x, layer, IN_Q, out_dtype=dt))


@pytest.mark.parametrize("act,qmax", [("gelu", 255.0), ("quick_gelu", 127.0)])
def test_int8_dense_gelu_q(dev, act, qmax):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-128, 128, (6304, 384), dtype=np.int8)).to(dev)
    layer = _layer(rng, 384, 1536, dev)
    gq = {"scale": torch.tensor(4.0 / 255), "zero_point": torch.tensor(11.0)}
    _same(fs.int8_dense_gelu_q(x, layer, IN_Q, gq, act=act, quant_max=qmax),
          fs.int8_dense_gelu_q_plain(x, layer, IN_Q, gq, act=act, quant_max=qmax))


@pytest.mark.parametrize("k,res,out", [(384, "bf16", "f32"), (1536, "f32", "bf16"),
                                       (768, "bf16", "bf16")])
def test_int8_dense_resid_ln_q(dev, k, res, out):
    rng = np.random.default_rng(k)
    m, n = 6304 + 5, 384 if k != 768 else 768
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to(dev)
    layer = _layer(rng, k, n, dev)
    rt = torch.bfloat16 if res == "bf16" else torch.float32
    r = torch.from_numpy(rng.normal(0, 1.5, (m, n)).astype(np.float32)).to(dev).to(rt)
    ot = torch.bfloat16 if out == "bf16" else torch.float32
    ln = _ln(rng, n, dev)
    _same(fs.int8_dense_resid_ln_q(x, layer, IN_Q, r, ln, OUT_Q, out_dtype=ot),
          fs.int8_dense_resid_ln_q_plain(x, layer, IN_Q, r, ln, OUT_Q, out_dtype=ot))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_quantize(dev, dtype):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 1.5, (32, 197, 384)).astype(np.float32)).to(dev).to(dtype)
    ln = _ln(rng, 384, dev)
    _same(fs.ln_quantize(x, ln, OUT_Q), fs.ln_quantize_plain(x, ln, OUT_Q))


@pytest.mark.parametrize("b,n,heads,hd,n_valid", [(8, 197, 6, 64, 197), (4, 32, 2, 64, 17),
                                                  (2, 197, 12, 64, 197), (2, 50, 4, 32, 50)])
def test_attention_q(dev, b, n, heads, hd, n_valid):
    rng = np.random.default_rng(n)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32))
    qkv = qkv.to(dev).to(torch.bfloat16)
    _same(fa.fused_attention_qkv(qkv, heads, hd, out_q=OUT_Q, n_valid=n_valid),
          fa.fused_attention_qkv_plain(qkv, heads, hd, out_q=OUT_Q, n_valid=n_valid))


def test_wrappers_check_inputs_and_never_fall_back(dev):
    rng = np.random.default_rng(3)
    layer = _layer(rng, 384, 384, dev)
    x = torch.from_numpy(rng.integers(-128, 128, (64, 384), dtype=np.int8)).to(dev)
    with pytest.raises(ValueError, match="dtype"):
        fs.int8_dense(x.to(torch.int32), layer, IN_Q)
    with pytest.raises(ValueError, match="contiguous"):
        fs.int8_dense(x.t().contiguous().t(), layer, IN_Q)
    with pytest.raises(ValueError, match="on cpu"):
        fs.int8_dense(x, {**layer, "w_int8": layer["w_int8"].cpu()}, IN_Q)
    with pytest.raises(ValueError, match="unsupported"):
        fs.int8_dense(x[:, :100].contiguous(), _layer(rng, 100, 384, dev), IN_Q)
    with pytest.raises(ValueError, match="dtype"):
        fa.fused_attention_qkv(torch.zeros(1, 8, 384 * 3, device=dev), 6, 64, out_q=OUT_Q)
    before = fs.int8_dense.launches
    fs.int8_dense(x, layer, IN_Q)
    assert fs.int8_dense.launches == before + 1


def test_megamodel_chain_matches_plain_chain(dev):
    """The whole K4 chain at micro size: kernels and plain versions agree
    bit for bit, and the predictor's CUDA preset runs through the kernels."""
    from qat_vit_tpu_torch.models.registry import create_model
    from qat_vit_tpu_torch.serve.calibrate import ptq_convert
    from qat_vit_tpu_torch.serve.int8_vit import export_to_device, int8_apply
    from qat_vit_tpu_torch.serve.predictor import Int8Predictor

    m = create_model("vit_micro_test", qat_wrapper=True,
                     generator=torch.Generator().manual_seed(0), device=dev)
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (8, 32, 32, 3))
                         .astype(np.float32)).to(dev)
    qp = export_to_device(ptq_convert(m.module.state_dict(), [x], m.cfg), dev)
    a = int8_apply(qp, x, m.cfg, compute_dtype=torch.bfloat16, fused="megamodel")
    b = int8_apply(qp, x, m.cfg, compute_dtype=torch.bfloat16, fused="megamodel_plain")
    assert torch.equal(a, b)
    pred = Int8Predictor(qp, m.cfg, batch_size=4, device=dev)
    assert pred.options["fused"] == "megamodel"
    before = fa.fused_attention_qkv.launches
    out = pred.logits(np.random.default_rng(5).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8))
    assert out.shape == (6, 10) and np.isfinite(out).all()
    assert fa.fused_attention_qkv.launches == before + 2 * m.cfg.depth
