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
from qat_vit_tpu_torch.ops import flash_attention_train as fat
from qat_vit_tpu_torch.ops._cuda import reference_impl

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


def _qkv_case(dev, b, n, heads, hd, seed):
    """Packed bf16 qkv, bf16 do, and qs = [scale, zp] on a grid whose ends
    clip part of the N(0, 1) qkv (|x| > ~2.1), so the STE mask is not all ones."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32))
    do = torch.from_numpy(rng.normal(0, 1, (b, n, heads * hd)).astype(np.float32))
    qs = torch.tensor([4.2 / 255, 127.0], dtype=torch.float32, device=dev)
    return qkv.to(dev).to(torch.bfloat16), do.to(dev).to(torch.bfloat16), qs


ATTN_SHAPES = [(8, 197, 6, 64, 197), (4, 32, 2, 64, 17), (2, 197, 12, 64, 197),
               (2, 50, 4, 32, 50)]


@pytest.mark.parametrize("fq", [False, True])
@pytest.mark.parametrize("b,n,heads,hd,n_valid", ATTN_SHAPES)
def test_attention_fwd(dev, b, n, heads, hd, n_valid, fq):
    """Kernel A (float output, with and without the in-kernel fake-quant)."""
    qkv, _, qs = _qkv_case(dev, b, n, heads, hd, n + heads)
    kw = {"qs": qs, "in_fq": (0, 255)} if fq else {}
    _same(fa.attention_fwd(qkv, heads, hd, n_valid=n_valid, **kw),
          fa.attention_fwd_plain(qkv, heads, hd, n_valid=n_valid, **kw))


@pytest.mark.parametrize("fq", [False, True])
@pytest.mark.parametrize("b,n,heads,hd,n_valid", ATTN_SHAPES)
def test_attention_bwd(dev, b, n, heads, hd, n_valid, fq):
    """Kernel B (with and without the STE mask)."""
    qkv, do, qs = _qkv_case(dev, b, n, heads, hd, 2 * n + heads)
    kw = {"qs": qs, "in_fq": (0, 255)} if fq else {}
    got = fat.attention_bwd(qkv, do, heads, hd, n_valid=n_valid, **kw)
    _same(got, fat.attention_bwd_plain(qkv, do, heads, hd, n_valid=n_valid, **kw))
    if fq:
        assert (got == 0).any() and (got != 0).any()


@pytest.mark.parametrize("fq", [False, True])
def test_attention_train_autograd(dev, fq):
    """The autograd Functions on the kernels vs the same Functions through
    the plain versions (``reference_impl``): forward and dqkv identical, and
    each kernel launches once per direction."""
    heads, hd = 6, 64
    qkv, do, qs = _qkv_case(dev, 4, 197, heads, hd, 11)

    def run():
        x = qkv.clone().requires_grad_(True)
        out = (fat.attention_train_fq(x, qs, heads, hd, 0, 255) if fq
               else fat.attention_train(x, heads, hd))
        (out.float() * do.float()).sum().backward()
        return out.detach(), x.grad

    fwd0, bwd0 = fa.attention_fwd.launches, fat.attention_bwd.launches
    out_k, grad_k = run()
    assert (fa.attention_fwd.launches, fat.attention_bwd.launches) == (fwd0 + 1, bwd0 + 1)
    with reference_impl():
        out_p, grad_p = run()
    assert (fa.attention_fwd.launches, fat.attention_bwd.launches) == (fwd0 + 1, bwd0 + 1)
    _same(out_k, out_p)
    _same(grad_k, grad_p)


def test_attention_train_wrappers_raise(dev):
    qkv, do, qs = _qkv_case(dev, 2, 32, 2, 64, 5)
    with pytest.raises(ValueError, match="dtype"):
        fa.attention_fwd(qkv.float(), 2, 64)
    with pytest.raises(ValueError, match="qs: on cpu"):
        fa.attention_fwd(qkv, 2, 64, qs=qs.cpu(), in_fq=(0, 255))
    with pytest.raises(ValueError, match="qs: missing"):
        fat.attention_bwd(qkv, do, 2, 64, in_fq=(0, 255))
    with pytest.raises(ValueError, match="do: shape"):
        fat.attention_bwd(qkv, do[:, :16].contiguous(), 2, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fa.attention_fwd(qkv.transpose(0, 1).contiguous().transpose(0, 1), 2, 64)
    long = torch.zeros(1, 400, 3 * 64, dtype=torch.bfloat16, device=dev)
    assert not fat.attention_train_available(1, 64, 400)
    with pytest.raises(ValueError, match="unsupported"):
        fat.attention_bwd(long, torch.zeros(1, 400, 64, dtype=torch.bfloat16, device=dev), 1, 64)


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


# ---------------------------------------------------------------------------
# the long-sequence attention kernel (K5a, K6's attention stage) and the K6 chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out", ["bf16", "int8"])
@pytest.mark.parametrize("b,n,heads,hd,n_valid", [(2, 197, 6, 64, 197), (2, 1000, 4, 32, 1000),
                                                  (1, 2305, 9, 64, 2305), (2, 2305, 3, 32, 2001)])
def test_long_attention(dev, b, n, heads, hd, n_valid, out):
    """Both entry points of csrc/attention_long.cu against their plain
    version: identical, bf16 and int8."""
    from qat_vit_tpu_torch.ops import long_attention as la

    rng = np.random.default_rng(n + hd)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32))
    qkv = qkv.to(dev).to(torch.bfloat16)
    out_q = OUT_Q if out == "int8" else None
    wrapper = la.long_attention_q if out_q else la.long_attention_qkv
    before = wrapper.launches
    got = la.long_attention_qkv(qkv, heads, hd, out_q=out_q, n_valid=n_valid)
    assert wrapper.launches == before + 1
    _same(got, la.long_attention_qkv_plain(qkv, heads, hd, out_q=out_q, n_valid=n_valid))


def test_long_attention_gate_raises(dev):
    """Beyond the shared-memory plan (one f32 score row per query of a
    block) the wrapper raises instead of falling back."""
    from qat_vit_tpu_torch.ops import long_attention as la

    assert la.long_attention_shapes_ok(6048, 64) and not la.long_attention_shapes_ok(6049, 64)
    qkv = torch.zeros(1, 7000, 3 * 64, dtype=torch.bfloat16, device=dev)
    before = la.long_attention_qkv.launches, la.long_attention_q.launches
    with pytest.raises(ValueError, match="unsupported"):
        la.long_attention_qkv(qkv, 1, 64)
    with pytest.raises(ValueError, match="unsupported"):
        la.long_attention_qkv(qkv, 1, 64, out_q=OUT_Q)
    with pytest.raises(ValueError, match="dtype"):
        la.long_attention_qkv(torch.zeros(1, 64, 3 * 64, device=dev), 1, 64)
    assert (la.long_attention_qkv.launches, la.long_attention_q.launches) == before


@pytest.fixture(scope="module")
def owlv2_export(dev):
    """OWLv2-pruned at full width (D 576, 9 heads, MLP 3072, 2,305 tokens),
    depth cut to 2, random init from seed 0, PTQ on one seeded image."""
    from qat_vit_tpu_torch.models.owlv2_detect import create_detector
    from qat_vit_tpu_torch.serve.calibrate import calibrate_detector
    from qat_vit_tpu_torch.serve.int8_detect import convert_detector
    from qat_vit_tpu_torch.serve.int8_vit import export_to_device

    det, cfg = create_detector(pruned=True, qat_wrapper=True, depth=2,
                               generator=torch.Generator().manual_seed(0), device=dev)
    x = torch.from_numpy(np.random.default_rng(7).normal(0, 1, (1, 768, 768, 3))
                         .astype(np.float32)).to(dev)
    params = {k: v for k, v in det.state_dict().items() if not k.endswith(("min_val", "max_val"))}
    export = convert_detector(params, calibrate_detector(params, [x], cfg), cfg)
    return cfg, export_to_device(export, dev), x


@pytest.mark.parametrize("depth", [1, 2])
def test_long_chain_matches_plain(dev, owlv2_export, depth):
    """One K6 block (long_block_forward) and a 2-block long_model_forward
    through the kernels against the same chain through the plain versions:
    identical x and zq."""
    from qat_vit_tpu_torch.ops import long_block_kernel as lbk
    from qat_vit_tpu_torch.serve.int8_vit import _embed

    cfg, export, x_img = owlv2_export
    qp = export["tower"]
    x = _embed(qp, x_img, cfg, torch.bfloat16, fs.int8_dense)
    blk0 = qp["blocks"]["0"]
    zq = fs.ln_quantize(x, blk0["norm1"], blk0["norm1"]["out_q"], eps=cfg.layer_norm_eps)
    kw = dict(num_heads=9, head_dim=64, act="quick_gelu", eps=cfg.layer_norm_eps, n_valid=2305)
    outs = []
    for ops in (lbk.LONG_KERNEL_OPS, lbk.LONG_PLAIN_OPS):
        if depth == 1:
            outs.append(lbk.long_block_forward(zq, x, blk0, qp["blocks"]["1"]["norm1"], ops=ops,
                                               **kw))
        else:
            outs.append(lbk.long_model_forward(zq, x, qp["blocks"], qp["norm"], depth=2, ops=ops,
                                               **kw))
    _same(outs[0], outs[1])


def test_detection_preset_runs_the_kernels(dev, owlv2_export):
    """The CUDA preset of a detector is the megamodel_long chain: five
    launches per block plus the entry patch GEMM and LN, and the output
    equals the plain chain's."""
    from qat_vit_tpu_torch.ops import long_attention as la
    from qat_vit_tpu_torch.serve.int8_detect import make_int8_detect_forward

    cfg, qp, x = owlv2_export
    fwd = make_int8_detect_forward(cfg, dev)
    assert fwd.options["fused"] == "megamodel_long"
    q = torch.from_numpy(np.random.default_rng(8).normal(0, 1, (1, 4, 512))
                         .astype(np.float32)).to(dev)
    wrappers = (fs.int8_dense, fs.int8_dense_resid_ln_q, fs.int8_dense_gelu_q, fs.ln_quantize,
                la.long_attention_q)
    before = [w.launches for w in wrappers]
    out = fwd(qp, x, q)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1 + 2, 2 * 2, 2, 1, 2]
    plain = make_int8_detect_forward(cfg, dev, fused="megamodel_long_plain")(qp, x, q)
    assert out.keys() == plain.keys()
    for k in out:
        _same(out[k], plain[k])


# ---------------------------------------------------------------------------
# the long-sequence attention backward (K5b) and the training pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n,heads,hd,n_valid", [(2, 197, 6, 64, 197), (2, 300, 3, 32, 290),
                                                  (1, 130, 2, 128, 130), (1, 520, 2, 72, 500),
                                                  (2, 2305, 9, 64, 2305)])
def test_long_attention_bwd(dev, b, n, heads, hd, n_valid):
    """csrc/attention_long_bwd.cu against its plain version: identical dqkv
    (both passes, both key-block shapes: hd <= 64 and hd up to 128); dq
    rows of padded queries and dk/dv rows of padded keys are zero."""
    from qat_vit_tpu_torch.ops import long_attention as la

    rng = np.random.default_rng(n + hd)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32))
    do = torch.from_numpy(rng.normal(0, 1, (b, n, heads * hd)).astype(np.float32))
    qkv, do = qkv.to(dev).to(torch.bfloat16), do.to(dev).to(torch.bfloat16)
    before = la.long_attention_bwd.launches
    got = la.long_attention_bwd(qkv, do, heads, hd, n_valid=n_valid)
    assert la.long_attention_bwd.launches == before + 2  # the rows and keys passes
    _same(got, la.long_attention_bwd_plain(qkv, do, heads, hd, n_valid=n_valid))
    assert not got[:, n_valid:].any() and got[:, :n_valid].any()


def test_long_attention_train_autograd(dev):
    """The training pair on the kernels vs the same Function through the
    plain versions (``reference_impl``): forward and dqkv identical; one K5a
    launch and K5b's two per step, none under the reference."""
    from qat_vit_tpu_torch.ops import long_attention as la

    heads, hd = 9, 64
    rng = np.random.default_rng(12)
    qkv = torch.from_numpy(rng.normal(0, 1, (2, 2305, 3 * heads * hd)).astype(np.float32))
    qkv = qkv.to(dev).to(torch.bfloat16)
    do = torch.from_numpy(rng.normal(0, 1, (2, 2305, heads * hd)).astype(np.float32)).to(dev)

    def run():
        x = qkv.clone().requires_grad_(True)
        out = la.long_attention_train(x, heads, hd)
        (out.float() * do).sum().backward()
        return out.detach(), x.grad

    fwd0, bwd0 = la.long_attention_qkv.launches, la.long_attention_bwd.launches
    out_k, grad_k = run()
    assert (la.long_attention_qkv.launches, la.long_attention_bwd.launches) == (fwd0 + 1, bwd0 + 2)
    with reference_impl():
        out_p, grad_p = run()
    assert (la.long_attention_qkv.launches, la.long_attention_bwd.launches) == (fwd0 + 1, bwd0 + 2)
    _same(out_k, out_p)
    _same(grad_k, grad_p)


def test_long_attention_bwd_raises(dev):
    """Outside its gate or on bad inputs the backward raises instead of
    falling back, and launches nothing."""
    from qat_vit_tpu_torch.ops import long_attention as la

    assert la.long_attention_bwd_shapes_ok(4960, 128) and not la.long_attention_bwd_shapes_ok(4961, 128)
    qkv = torch.zeros(1, 64, 3 * 64, dtype=torch.bfloat16, device=dev)
    do = torch.zeros(1, 64, 64, dtype=torch.bfloat16, device=dev)
    before = la.long_attention_bwd.launches
    with pytest.raises(ValueError, match="unsupported"):
        la.long_attention_bwd(torch.zeros(1, 5000, 3 * 128, dtype=torch.bfloat16, device=dev),
                              torch.zeros(1, 5000, 128, dtype=torch.bfloat16, device=dev), 1, 128)
    with pytest.raises(ValueError, match="do: dtype"):
        la.long_attention_bwd(qkv, do.float(), 1, 64)
    with pytest.raises(ValueError, match="do: shape"):
        la.long_attention_bwd(qkv, do[:, :32].contiguous(), 1, 64)
    with pytest.raises(ValueError, match="qkv: dtype"):
        la.long_attention_bwd(qkv.float(), do, 1, 64)
    assert la.long_attention_bwd.launches == before
