"""The port's Hopper kernels against their plain versions, on the card.

Marked ``requires_cuda``; each test skips without a CUDA device. The
machine with the card has no JAX, so run this file without the suite's
conftest::

    python -m pytest --noconftest -m requires_cuda tests/test_torch_port_cuda.py -q

Every kernel pins its roundings to its plain version (f64 LN and softmax
sums, index-ordered f32 dots), so outputs must be IDENTICAL, int8 and float,
except the attentions on the tensor cores, which sum in their own order and
use the card's ``ex2``; each gives identical bits over two launches:

- the bf16 long attention pair (K5a ``qvt_attention_long_mma``, K5b
  ``qvt_attention_long_bwd_mma``), the bf16 kernels A
  (``qvt_attention_fwd_mma``) and B (``qvt_attention_bwd_mma``) and the
  bf16 K8 (``qvt_flash_attention_mma``) are held by
  :func:`assert_tc_close` to the tolerance of ``long_attention.tc_errors``
  against their plain versions and to the plain versions' own accuracy
  against the f64 math (kernels A's and B's of the fake-quantized qkv;
  kernel B's zeros where the STE mask is off, as the plain version's);
- K6a (``qvt_attention_long_q_mma``, ``qvt_attention_long_q8_mma``) and K3
  (``qvt_attention_q_mma``) give int8 outputs held by :func:`_int8_close`
  (at most one grid step off, >= 99.9% identical), and a chain through the
  kernels is held to its plain twin with the kernel as its attention stage
  (:func:`_plain_ops_with_kernel_attention`, :func:`_plain_ops_with_k3`):
  identical. K9a / K9b run the chain kernels' stage code, K3's tensor-core
  tile included: identical to the kernel chain and to that twin.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qat_vit_tpu_torch.ops import fused_serve as fs
from qat_vit_tpu_torch.ops import flash_attention as fa
from qat_vit_tpu_torch.ops import flash_attention_train as fat
from qat_vit_tpu_torch.ops import long_attention as la
from qat_vit_tpu_torch.ops._cuda import reference_impl

pytestmark = pytest.mark.requires_cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are sm_90a CUDA with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(rng, k, n, dev, per_channel=False, packed=True):
    """A random int8 GEMM layer of the export's layout, with the packed
    ``w_int8_t`` that export_to_device adds on the card (``packed``)."""
    w = np.clip(np.round(rng.normal(0, 20, (k, n))), -128, 127).astype(np.int8)
    layer = {
        "w_int8": torch.from_numpy(w).to(dev),
        "w_colsum": torch.from_numpy(w.astype(np.int32).sum(0, dtype=np.int32)).to(dev),
        "bias": torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)).to(dev),
        "w_scale": (torch.from_numpy(rng.uniform(1e-3, 3e-3, n).astype(np.float32)).to(dev)
                    if per_channel else torch.tensor(0.002)),
    }
    return fs.with_packed_weight(layer) if packed else layer


def _without_packed(layer):
    return {k: v for k, v in layer.items() if k != "w_int8_t"}


def _ln(rng, n, dev):
    return {"scale": torch.from_numpy(rng.normal(1, 0.2, n).astype(np.float32)).to(dev),
            "bias": torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32)).to(dev)}


IN_Q = {"scale": torch.tensor(0.02), "zero_point": torch.tensor(121.0)}
OUT_Q = {"scale": torch.tensor(8.0 / 255), "zero_point": torch.tensor(128.0)}


def assert_tc_close(got, plain, ref, sections):
    """A tensor-core output ``got`` (``sections`` equal column blocks: 1 for
    the forward, 3 for dqkv) within the bf16 pair's tolerance
    (``long_attention.tc_errors``) of its plain version and the f64 math."""
    ok, errs = la.tc_errors(got, plain, ref, sections)
    assert ok, errs


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), (x.float() - y.float()).abs().max()


def _int8_close(got, want):
    """K6a's bound: int8 outputs at most one grid step from the plain
    version's, at least 99.9% identical."""
    assert got.dtype == want.dtype == torch.int8 and got.shape == want.shape
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    worst, exact = int(diff.max()), float((diff == 0).float().mean())
    assert worst <= 1 and exact >= 0.999, (worst, exact)


def _plain_ops_with_kernels(ops, calls=None, **pairs):
    """The plain ops ``ops`` (``block_kernel.PLAIN_OPS`` or
    ``long_block_kernel.LONG_PLAIN_OPS``) with each entry of ``pairs``
    (name -> (kernel, plain version)) as a stage that runs the kernel and the
    plain version on the same inputs, holds the kernel to
    :func:`_int8_close`, appends its qkv's shape to ``calls`` and returns the
    kernel's output. A chain through these equals the kernel chain exactly
    where everything but the attention replays its plain version."""
    def held(kernel, plain):
        def stage(*args, **kwargs):
            got = kernel(*args, **kwargs)
            _int8_close(got, plain(*args, **kwargs))
            if calls is not None:
                calls.append(args[-3].shape)
            return got
        return stage

    return SimpleNamespace(**{**vars(ops), **{n: held(*p) for n, p in pairs.items()}})


def _plain_ops_with_k3(calls=None):
    """The short chains' plain ops with K3 as their attention stage."""
    from qat_vit_tpu_torch.ops import block_kernel as bk

    return _plain_ops_with_kernels(
        bk.PLAIN_OPS, calls, attention=(fa.fused_attention_qkv, fa.fused_attention_qkv_plain))


def _plain_ops_with_kernel_attention():
    """The long chains' plain ops with K6a as their attention stages."""
    from qat_vit_tpu_torch.ops import long_block_kernel as lbk

    return _plain_ops_with_kernels(
        lbk.LONG_PLAIN_OPS, attention=(la.long_attention_qkv, la.long_attention_qkv_plain),
        attention_q8=(la.long_attention_q8, la.long_attention_q8_plain))


@pytest.mark.parametrize("m,k,n,per_channel,out", [
    # ViT-S qkv, patch embedding and head at batch 32 and 256
    (6304, 384, 1152, False, "bf16"), (6272, 768, 384, False, "bf16"),
    (32, 384, 10, True, "f32"), (50_432, 384, 1152, False, "bf16"),
    (50_176, 768, 384, False, "bf16"), (256, 384, 10, True, "f32"),
    # ragged M and N, K = 32 (mod 64), per-channel scales
    (37, 128, 384, False, "f32"), (1, 96, 200, True, "f32"), (37, 480, 10, False, "bf16"),
    (37, 96, 200, True, "bf16"), (1, 480, 384, False, "f32"), (6304 + 5, 480, 1440, True, "bf16"),
])
def test_int8_dense(dev, m, k, n, per_channel, out):
    """K2a (PLAIN, the TMA + wgmma kernel) identical to its plain version;
    a layer without the packed weight raises before any launch."""
    rng = np.random.default_rng(m + n)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to(dev)
    layer = _layer(rng, k, n, dev, per_channel)
    dt = torch.bfloat16 if out == "bf16" else torch.float32
    before = fs.int8_dense.launches
    _same(fs.int8_dense(x, layer, IN_Q, out_dtype=dt),
          fs.int8_dense_plain(x, layer, IN_Q, out_dtype=dt))
    with pytest.raises(ValueError, match="w_int8_t"):
        fs.int8_dense(x, _without_packed(layer), IN_Q, out_dtype=dt)
    assert fs.int8_dense.launches == before + 1


@pytest.mark.parametrize("m,k,n,act,qmax,per_channel", [
    (6304, 384, 1536, "gelu", 255.0, False), (6304, 384, 1536, "quick_gelu", 127.0, False),
    (50_432, 384, 1536, "gelu", 255.0, False),
    (4610, 576, 3072, "quick_gelu", 255.0, False),  # OWLv2-pruned fc1 at batch 2
    (37, 480, 200, "gelu", 255.0, True), (1, 96, 10, "quick_gelu", 255.0, True),
    (6304 + 5, 480, 1920, "gelu", 127.0, False),
])
def test_int8_dense_gelu_q(dev, m, k, n, act, qmax, per_channel):
    """K2b (GELU_Q, the TMA + wgmma kernel) identical to its plain version;
    a layer without the packed weight raises."""
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to(dev)
    layer = _layer(rng, k, n, dev, per_channel)
    gq = {"scale": torch.tensor(4.0 / 255), "zero_point": torch.tensor(11.0)}
    before = fs.int8_dense_gelu_q.launches
    _same(fs.int8_dense_gelu_q(x, layer, IN_Q, gq, act=act, quant_max=qmax),
          fs.int8_dense_gelu_q_plain(x, layer, IN_Q, gq, act=act, quant_max=qmax))
    with pytest.raises(ValueError, match="w_int8_t"):
        fs.int8_dense_gelu_q(x, _without_packed(layer), IN_Q, gq, act=act, quant_max=qmax)
    assert fs.int8_dense_gelu_q.launches == before + 1


@pytest.mark.parametrize("m,k,n,res,out", [
    (6304 + 5, 384, 384, "bf16", "f32"), (6304 + 5, 1536, 384, "f32", "bf16"),
    (6304 + 5, 768, 768, "bf16", "bf16"),
    # the main paths: ViT-S proj / fc2 at batch 32 and 256, OWLv2 proj / fc2
    # at batch 2 and 8 (block rows 32 and 64)
    (6304, 384, 384, "bf16", "f32"), (6304, 1536, 384, "f32", "bf16"),
    (50_432, 1536, 384, "f32", "bf16"), (4610, 576, 576, "bf16", "f32"),
    (4610, 3072, 576, "f32", "bf16"), (18_440, 3072, 576, "f32", "bf16"),
    # the largest N the gate admits (16 rows a block), and a short ragged M
    (300, 384, 1756, "bf16", "f32"), (37, 128, 200, "f32", "f32"),
    # K = 32 (mod 64): the last k-step half zero-filled
    (37, 96, 200, "f32", "f32"), (6304 + 5, 480, 384, "bf16", "bf16"),
])
def test_int8_dense_resid_ln_q(dev, m, k, n, res, out):
    """K2c (``qvt_int8_gemm_resid_ln``, the pipelined tile) identical to its
    plain version, y and q, from the packed weight; a layer without one
    raises."""
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to(dev)
    layer = _layer(rng, k, n, dev, packed=False)
    rt = torch.bfloat16 if res == "bf16" else torch.float32
    r = torch.from_numpy(rng.normal(0, 1.5, (m, n)).astype(np.float32)).to(dev).to(rt)
    ot = torch.bfloat16 if out == "bf16" else torch.float32
    ln = _ln(rng, n, dev)
    before = fs.int8_dense_resid_ln_q.launches
    got = fs.int8_dense_resid_ln_q(x, fs.with_packed_weight(layer), IN_Q, r, ln, OUT_Q,
                                   out_dtype=ot)
    assert fs.int8_dense_resid_ln_q.launches == before + 1
    _same(got, fs.int8_dense_resid_ln_q_plain(x, layer, IN_Q, r, ln, OUT_Q, out_dtype=ot))
    with pytest.raises(ValueError, match="w_int8_t"):
        fs.int8_dense_resid_ln_q(x, layer, IN_Q, r, ln, OUT_Q, out_dtype=ot)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_quantize(dev, dtype):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 1.5, (32, 197, 384)).astype(np.float32)).to(dev).to(dtype)
    ln = _ln(rng, 384, dev)
    _same(fs.ln_quantize(x, ln, OUT_Q), fs.ln_quantize_plain(x, ln, OUT_Q))


# K2d at chip_smoke.py's phase-2 shapes: ViT-S at batch 32 and 256, the
# OWLv2-pruned detection forward, ViT-B's and ViT-L's widths (the register
# form), one width past its plan and an odd width (the strided form)
LN_SHAPES = [(6304, 384), (50432, 384), (18440, 576), (6304, 768), (6304, 1024), (6304, 1280),
             (6304, 385)]


@pytest.mark.parametrize("m,n", LN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_quantize_forms(dev, m, n, dtype):
    """Each form identical to the plain version, two launches identical, one
    count per launch; the plan's form: registers to 1,024 wide, strided past
    it and at odd widths."""
    rng = np.random.default_rng(m + n)
    x = torch.from_numpy(rng.normal(0.3, 1.5, (m, n)).astype(np.float32)).to(dev).to(dtype)
    ln = _ln(rng, n, dev)
    vec, nv = fs.ln_quantize_plan(n, x.element_size(), fs.pointer_align(x))
    assert (vec > 0) == (n <= 1024 and n % 4 == 0)
    before = fs.ln_quantize.launches
    got, again = fs.ln_quantize(x, ln, OUT_Q), fs.ln_quantize(x, ln, OUT_Q)
    assert fs.ln_quantize.launches == before + 2
    _same(got, fs.ln_quantize_plain(x, ln, OUT_Q))
    _same(got, again)


def test_ln_quantize_off_alignment_and_eps(dev):
    """A row view 8 bytes off a 16-byte boundary: bf16 takes 8-byte vectors,
    f32 the strided form; both identical to the plain version at eps 1e-5,
    qmax 127 and a batch of one row."""
    rng = np.random.default_rng(5)
    ln = _ln(rng, 384, dev)
    for dtype, form in ((torch.bfloat16, (8, 3)), (torch.float32, (0, 0))):
        pad = 8 // torch.tensor([], dtype=dtype).element_size()
        base = torch.from_numpy(rng.normal(0, 2, 37 * 384 + pad).astype(np.float32)).to(dev)
        x = base.to(dtype)[pad:].view(37, 384)
        assert fs.ln_quantize_plan(384, x.element_size(), fs.pointer_align(x)) == form
        for rows in (x, x[:1]):
            _same(fs.ln_quantize(rows, ln, OUT_Q, eps=1e-5, quant_max=127.0),
                  fs.ln_quantize_plain(rows, ln, OUT_Q, eps=1e-5, quant_max=127.0))


# ViT-S and ViT-B heads, masked keys, odd N, hd 8 to 128 and the gate's edges:
# K and V resident (N 789 at hd 64, 416 at hd 128) or streamed (N 1,411 at hd
# 32, 710 at hd 72)
SHORT_SHAPES = [(8, 197, 6, 64, 197), (4, 32, 2, 64, 17), (2, 197, 12, 64, 197),
                (2, 50, 4, 32, 50), (3, 5, 2, 64, 4), (2, 1, 2, 64, 1), (2, 33, 3, 8, 33),
                (2, 77, 2, 128, 70), (1, 789, 2, 64, 789), (1, 416, 1, 128, 400),
                (1, 1411, 1, 32, 1411), (1, 710, 1, 72, 700)]


@pytest.mark.parametrize("b,n,heads,hd,n_valid", SHORT_SHAPES)
def test_attention_q(dev, b, n, heads, hd, n_valid):
    """K3 on the tensor cores: within the int8 bound of its plain version,
    two launches identical, one launch per call."""
    rng = np.random.default_rng(n)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32))
    qkv = qkv.to(dev).to(torch.bfloat16)
    before = fa.fused_attention_qkv.launches
    got = fa.fused_attention_qkv(qkv, heads, hd, out_q=OUT_Q, n_valid=n_valid)
    assert fa.fused_attention_qkv.launches == before + 1
    _int8_close(got, fa.fused_attention_qkv_plain(qkv, heads, hd, out_q=OUT_Q, n_valid=n_valid))
    _same(got, fa.fused_attention_qkv(qkv, heads, hd, out_q=OUT_Q, n_valid=n_valid))


def _qkv_case(dev, b, n, heads, hd, seed):
    """Packed bf16 qkv, bf16 do, and qs = [scale, zp] on a grid whose ends
    clip part of the N(0, 1) qkv (|x| > ~2.1), so the STE mask is not all ones."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32))
    do = torch.from_numpy(rng.normal(0, 1, (b, n, heads * hd)).astype(np.float32))
    qs = torch.tensor([4.2 / 255, 127.0], dtype=torch.float32, device=dev)
    return qkv.to(dev).to(torch.bfloat16), do.to(dev).to(torch.bfloat16), qs


# kernel B's shapes, N 512 past the old shared-memory plans (6 heads of 64
# and of 128) among them
ATTN_SHAPES = [(8, 197, 6, 64, 197), (4, 32, 2, 64, 17), (2, 197, 12, 64, 197),
               (2, 50, 4, 32, 50), (2, 77, 2, 128, 70), (2, 512, 6, 64, 500),
               (2, 512, 6, 128, 512)]
# kernel A also at N 512 (K3's gate stops at 416 at hd 128)
PAST_PLAN = [(2, 512, 6, 64, 512), (2, 512, 6, 128, 500)]


@pytest.mark.parametrize("fq", [False, True])
@pytest.mark.parametrize("b,n,heads,hd,n_valid", SHORT_SHAPES + PAST_PLAN)
def test_attention_fwd(dev, b, n, heads, hd, n_valid, fq):
    """Kernel A in bf16 on the tensor cores (with and without the in-kernel
    fake-quant): within the tolerance of ``tc_errors`` against its plain
    version and the f64 math, two launches identical."""
    qkv, _, qs = _qkv_case(dev, b, n, heads, hd, n + heads)
    kw = {"qs": qs, "in_fq": (0, 255)} if fq else {}
    got = fa.attention_fwd(qkv, heads, hd, n_valid=n_valid, **kw)
    assert_tc_close(got, fa.attention_fwd_plain(qkv, heads, hd, n_valid=n_valid, **kw),
                    la.long_attention_f64(qkv, heads, hd, n_valid=n_valid, **kw)[0], 1)
    _same(got, fa.attention_fwd(qkv, heads, hd, n_valid=n_valid, **kw))


@pytest.mark.parametrize("fq", [False, True])
@pytest.mark.parametrize("b,n,heads,hd,n_valid", ATTN_SHAPES)
def test_attention_bwd(dev, b, n, heads, hd, n_valid, fq):
    """Kernel B in bf16 on the tensor cores (with and without the STE mask):
    dq, dk, dv within rel L2 1e-2 of its plain version and at most twice the
    plain version's rel L2 to the f64 math, two launches identical, zero
    wherever the STE mask of the raw qkv is off, as the plain version."""
    from qat_vit_tpu_torch.quant.fake_quant import ste_mask

    qkv, do, qs = _qkv_case(dev, b, n, heads, hd, 2 * n + heads)
    kw = {"qs": qs, "in_fq": (0, 255)} if fq else {}
    got = fat.attention_bwd(qkv, do, heads, hd, n_valid=n_valid, **kw)
    want = fat.attention_bwd_plain(qkv, do, heads, hd, n_valid=n_valid, **kw)
    assert_tc_close(got, want, la.long_attention_f64(qkv, heads, hd, do, n_valid=n_valid,
                                                     **kw)[1], 3)
    _same(got, fat.attention_bwd(qkv, do, heads, hd, n_valid=n_valid, **kw))
    if fq:
        off = ~ste_mask(qkv, qs[0], qs[1], 0, 255)
        assert off.any() and not got[off].any() and not want[off].any()
        assert (got != 0).any()


@pytest.mark.parametrize("fq", [False, True])
def test_attention_train_autograd(dev, fq):
    """The autograd Functions on the kernels vs the same Functions through
    the plain versions (``reference_impl``): the forward within kernel A's
    tolerance, dqkv within kernel B's (both on the tensor cores), and each
    kernel launches once per direction."""
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
    kw = {"qs": qs, "in_fq": (0, 255)} if fq else {}
    out_f64, grad_f64 = la.long_attention_f64(qkv, heads, hd, do, **kw)
    assert_tc_close(out_k, out_p, out_f64, 1)
    assert_tc_close(grad_k, grad_p, grad_f64, 3)


def test_attention_train_wrappers_raise(dev):
    qkv, do, qs = _qkv_case(dev, 2, 32, 2, 64, 5)
    with pytest.raises(ValueError, match="dtype"):
        fa.attention_fwd(qkv.half(), 2, 64)
    with pytest.raises(ValueError, match="qs: on cpu"):
        fa.attention_fwd(qkv, 2, 64, qs=qs.cpu(), in_fq=(0, 255))
    with pytest.raises(ValueError, match="qs: missing"):
        fat.attention_bwd(qkv, do, 2, 64, in_fq=(0, 255))
    with pytest.raises(ValueError, match="do: shape"):
        fat.attention_bwd(qkv, do[:, :16].contiguous(), 2, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fa.attention_fwd(qkv.transpose(0, 1).contiguous().transpose(0, 1), 2, 64)
    assert not fat.attention_train_available(1, 64, 400)  # JAX's lane condition
    with pytest.raises(ValueError, match="unsupported"):
        fat.attention_bwd(torch.zeros(1, 17, 3 * 60, dtype=torch.bfloat16, device=dev),
                          torch.zeros(1, 17, 60, dtype=torch.bfloat16, device=dev), 1, 60)


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


def test_megamodel_chain_matches_plain_chain(dev, monkeypatch):
    """The whole K4 chain at micro size: identical to the plain chain with
    K3 as its attention stage (each call within the int8 bound) and within
    the exact-path bound (rel L2 0.2) of the exact f32 path; the
    predictor's CUDA preset runs through the kernels."""
    from qat_vit_tpu_torch.serve import int8_vit
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
    exact = int8_apply(qp, x, m.cfg)
    assert la.rel_l2(a, exact) <= 0.2
    calls = []
    with monkeypatch.context() as mp:
        mp.setattr(int8_vit, "PLAIN_OPS", _plain_ops_with_k3(calls))
        b = int8_apply(qp, x, m.cfg, compute_dtype=torch.bfloat16, fused="megamodel_plain")
    assert torch.equal(a, b) and len(calls) == m.cfg.depth
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
    """Both entry points of the bf16 long attention against their plain
    version, both on the tensor cores: the int8 form (K6a,
    csrc/attention_long_q_mma.cu) within K6a's int8 bound, the bf16 form
    (csrc/attention_long_mma.cu) within the pair's bounds."""
    from qat_vit_tpu_torch.ops import long_attention as la

    rng = np.random.default_rng(n + hd)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32))
    qkv = qkv.to(dev).to(torch.bfloat16)
    out_q = OUT_Q if out == "int8" else None
    wrapper = la.long_attention_q if out_q else la.long_attention_qkv
    before = wrapper.launches
    got = la.long_attention_qkv(qkv, heads, hd, out_q=out_q, n_valid=n_valid)
    assert wrapper.launches == before + 1
    want = la.long_attention_qkv_plain(qkv, heads, hd, out_q=out_q, n_valid=n_valid)
    if out_q:
        _int8_close(got, want)
    else:
        assert_tc_close(got, want, la.long_attention_f64(qkv, heads, hd, n_valid=n_valid)[0], 1)


@pytest.mark.parametrize("form", ["bf16", "i8"])
@pytest.mark.parametrize("b,n,heads,hd,n_valid", [(1, 10_001, 2, 64, 10_001),
                                                  (1, 10_001, 1, 72, 9_990),
                                                  (2, 2305, 9, 64, 2001), (1, 520, 2, 72, 500),
                                                  (2, 300, 2, 128, 290), (1, 77, 3, 40, 77)])
def test_long_attention_q_streaming(dev, b, n, heads, hd, n_valid, form):
    """K6a in both score forms past the old score-row plan (10,001 tokens,
    1,600 px), with masked keys, and at hd 72, 128 and 40 (the int8 dot
    zero-filled to a multiple of 32, 8-byte copies of its rows): within the
    int8 bound of the plain versions; two launches identical."""
    rng = np.random.default_rng(n + hd + heads)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32))
    qkv = qkv.to(dev).to(torch.bfloat16)
    if form == "bf16":
        out_q = {"scale": torch.tensor(2.0 / 255), "zero_point": torch.tensor(128.0)}
        before = la.long_attention_q.launches
        got = la.long_attention_q(qkv, heads, hd, out_q=out_q, n_valid=n_valid)
        assert la.long_attention_q.launches == before + 1
        want = la.long_attention_qkv_plain(qkv, heads, hd, out_q=out_q, n_valid=n_valid)
        again = la.long_attention_q(qkv, heads, hd, out_q=out_q, n_valid=n_valid)
    else:
        out_q = {"scale": torch.tensor(0.03), "zero_point": torch.tensor(131.0)}
        qk8 = np.clip(np.round(rng.normal(3, 60, (b, n, 2 * heads * hd))), -128, 127)
        qk8 = torch.from_numpy(qk8.astype(np.int8)).to(dev)
        before = la.long_attention_q8.launches
        got = la.long_attention_q8(qk8, qkv, heads, hd, out_q=out_q, n_valid=n_valid)
        assert la.long_attention_q8.launches == before + 1
        want = la.long_attention_q8_plain(qk8, qkv, heads, hd, out_q=out_q, n_valid=n_valid)
        again = la.long_attention_q8(qk8, qkv, heads, hd, out_q=out_q, n_valid=n_valid)
    _int8_close(got, want)
    assert torch.equal(got, again)


def test_long_attention_gate_raises(dev):
    """The gates are split: the bf16 forms (K5a, and K6a's two int8-output
    forms) stream K and V on the tensor cores and take any N at hd a
    multiple of 8 up to 128; the f32 form runs kernel A's f32 kernel, whose
    strips of score rows take N to 39,080 at hd 128 (7,000 tokens here run),
    and past that plan it raises instead of falling back."""
    from qat_vit_tpu_torch.ops import long_attention as la

    assert la.long_attention_shapes_ok(7000, 64, torch.float32)
    assert not la.long_attention_shapes_ok(39_081, 128, torch.float32)
    assert la.long_attention_stream_ok(7000, 64) and la.long_attention_stream_ok(100_000, 128)
    assert not la.long_attention_stream_ok(7000, 60) and not la.long_attention_stream_ok(64, 136)
    qkv = torch.zeros(1, 7000, 3 * 64, dtype=torch.bfloat16, device=dev)
    before = la.long_attention_qkv.launches, la.long_attention_q.launches
    with pytest.raises(ValueError, match="unsupported"):
        la.long_attention_qkv(qkv[..., :3 * 60].contiguous(), 1, 60, out_q=OUT_Q)
    with pytest.raises(ValueError, match="unsupported"):
        la.long_attention_qkv(torch.zeros(1, 39_081, 3 * 128, device=dev), 1, 128)
    with pytest.raises(ValueError, match="unsupported"):
        la.long_attention_qkv(torch.zeros(1, 64, 3 * 60, dtype=torch.bfloat16, device=dev), 1, 60)
    with pytest.raises(ValueError, match="dtype"):
        la.long_attention_qkv(torch.zeros(1, 64, 3 * 64, dtype=torch.float16, device=dev), 1, 64)
    with pytest.raises(ValueError, match="dtype"):  # the int8 forms are bf16-only
        la.long_attention_qkv(torch.zeros(1, 64, 3 * 64, device=dev), 1, 64, out_q=OUT_Q)
    assert (la.long_attention_qkv.launches, la.long_attention_q.launches) == before
    la.long_attention_qkv(qkv.float(), 1, 64)
    assert la.long_attention_qkv.launches == before[0] + 1


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
    through the kernels against the same chain through the plain versions
    with the kernels' attention stage (each attention call within K6a's
    int8 bound of its plain version): identical x and zq."""
    from qat_vit_tpu_torch.ops import long_block_kernel as lbk
    from qat_vit_tpu_torch.serve.int8_vit import _embed

    cfg, export, x_img = owlv2_export
    qp = export["tower"]
    x = _embed(qp, x_img, cfg, torch.bfloat16, fs.int8_dense)
    blk0 = qp["blocks"]["0"]
    zq = fs.ln_quantize(x, blk0["norm1"], blk0["norm1"]["out_q"], eps=cfg.layer_norm_eps)
    kw = dict(num_heads=9, head_dim=64, act="quick_gelu", eps=cfg.layer_norm_eps, n_valid=2305)
    outs = []
    for ops in (lbk.LONG_KERNEL_OPS, _plain_ops_with_kernel_attention()):
        if depth == 1:
            outs.append(lbk.long_block_forward(zq, x, blk0, qp["blocks"]["1"]["norm1"], ops=ops,
                                               **kw))
        else:
            outs.append(lbk.long_model_forward(zq, x, qp["blocks"], qp["norm"], depth=2, ops=ops,
                                               **kw))
    _same(outs[0], outs[1])


def test_detection_preset_runs_the_kernels(dev, owlv2_export, monkeypatch):
    """The CUDA preset of a detector is the megamodel_long chain: five
    launches per block plus the entry patch GEMM and LN, and the output
    equals the plain chain's with the kernels' attention stage."""
    from qat_vit_tpu_torch.ops import long_attention as la
    from qat_vit_tpu_torch.serve import int8_vit
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
    monkeypatch.setattr(int8_vit, "LONG_PLAIN_OPS", _plain_ops_with_kernel_attention())
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
    """csrc/attention_long_bwd_mma.cu (tensor cores) against its plain
    version within the pair's bounds (both passes, both tile shapes: hd <=
    64 and hd up to 128), from its own forward's output and log-sum-exp
    (one launch of the forward) and from them given; dq rows of padded
    queries and dk/dv rows of padded keys are zero."""
    from qat_vit_tpu_torch.ops import long_attention as la

    rng = np.random.default_rng(n + hd)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32))
    do = torch.from_numpy(rng.normal(0, 1, (b, n, heads * hd)).astype(np.float32))
    qkv, do = qkv.to(dev).to(torch.bfloat16), do.to(dev).to(torch.bfloat16)
    before = la.long_attention_bwd.launches, la.long_attention_qkv.launches
    got = la.long_attention_bwd(qkv, do, heads, hd, n_valid=n_valid)
    assert (la.long_attention_bwd.launches, la.long_attention_qkv.launches) == (
        before[0] + 2, before[1] + 1)  # the rows and keys passes, after the forward
    out, lse = la._attention_launch(qkv, heads, hd, n_valid, want_lse=True)
    assert torch.equal(la.long_attention_bwd(qkv, do, heads, hd, n_valid=n_valid, out=out,
                                             lse=lse), got)
    assert la.long_attention_qkv.launches == before[1] + 2
    ref = la.long_attention_f64(qkv, heads, hd, do, n_valid=n_valid)[1]
    assert_tc_close(got, la.long_attention_bwd_plain(qkv, do, heads, hd, n_valid=n_valid), ref, 3)
    assert not got[:, n_valid:].any() and got[:, :n_valid].any()


def test_long_attention_past_the_plan(dev):
    """The bf16 pair past the f32 plan's 6,048 tokens: [1, 7000, 192], one
    head of 64, n_valid 6,990, forward and backward within the pair's
    bounds; two launches of each identical; the training pair at N 7,000
    within them against itself through the plain versions."""
    from qat_vit_tpu_torch.ops import long_attention as la

    rng = np.random.default_rng(7000)
    n, nv = 7000, 6990
    qkv = torch.from_numpy(rng.normal(0, 1, (1, n, 192)).astype(np.float32)).to(dev).bfloat16()
    do = torch.from_numpy(rng.normal(0, 1, (1, n, 64)).astype(np.float32)).to(dev).bfloat16()
    out = la.long_attention_qkv(qkv, 1, 64, n_valid=nv)
    assert torch.equal(out, la.long_attention_qkv(qkv, 1, 64, n_valid=nv))
    ref_out, ref_grad = la.long_attention_f64(qkv, 1, 64, do, n_valid=nv)
    assert_tc_close(out, la.long_attention_qkv_plain(qkv, 1, 64, n_valid=nv), ref_out, 1)
    grad = la.long_attention_bwd(qkv, do, 1, 64, n_valid=nv)
    assert torch.equal(grad, la.long_attention_bwd(qkv, do, 1, 64, n_valid=nv))
    assert_tc_close(grad, la.long_attention_bwd_plain(qkv, do, 1, 64, n_valid=nv), ref_grad, 3)
    assert not grad[:, nv:].any()

    def run():
        x = qkv.clone().requires_grad_(True)
        y = la.long_attention_train(x, 1, 64)
        (y.float() * do.float()).sum().backward()
        return y.detach(), x.grad

    out_k, grad_k = run()
    with reference_impl():
        out_p, grad_p = run()
    ref_out, ref_grad = la.long_attention_f64(qkv, 1, 64, do)
    assert_tc_close(out_k, out_p, ref_out, 1)
    assert_tc_close(grad_k, grad_p, ref_grad, 3)


def test_long_attention_train_autograd(dev):
    """The training pair on the kernels vs the same Function through the
    plain versions (``reference_impl``): forward and dqkv within the pair's
    bounds; one K5a launch and K5b's two per step (the backward takes the
    forward's saved output and log-sum-exp), none under the reference."""
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
    ref_out, ref_grad = la.long_attention_f64(qkv, heads, hd, do)
    assert_tc_close(out_k, out_p, ref_out, 1)
    assert_tc_close(grad_k, grad_p, ref_grad, 3)


def test_long_attention_bwd_raises(dev):
    """Outside its gate or on bad inputs the backward raises instead of
    falling back, and launches nothing. The gates are split: bf16 takes any
    N (the tensor-core pair), f32 kernel B's rows-pass plan (18,472 tokens
    at hd 128; its own earlier plan ended at 5,024)."""
    from qat_vit_tpu_torch.ops import long_attention as la

    assert la.long_attention_bwd_shapes_ok(4961, 128) and la.long_attention_bwd_shapes_ok(100_000, 128)
    assert (la.long_attention_bwd_shapes_ok(18_472, 128, torch.float32)
            and not la.long_attention_bwd_shapes_ok(18_473, 128, torch.float32))
    qkv = torch.zeros(1, 64, 3 * 64, dtype=torch.bfloat16, device=dev)
    do = torch.zeros(1, 64, 64, dtype=torch.bfloat16, device=dev)
    before = la.long_attention_bwd.launches
    with pytest.raises(ValueError, match="unsupported"):
        la.long_attention_bwd(torch.zeros(1, 18_473, 3 * 128, device=dev),
                              torch.zeros(1, 18_473, 128, device=dev), 1, 128)
    with pytest.raises(ValueError, match="unsupported"):
        la.long_attention_bwd(torch.zeros(1, 64, 3 * 60, dtype=torch.bfloat16, device=dev),
                              torch.zeros(1, 64, 60, dtype=torch.bfloat16, device=dev), 1, 60)
    with pytest.raises(ValueError, match="lse: shape"):
        la.long_attention_bwd(qkv, do, 1, 64, out=do, lse=torch.zeros(1, 1, 32, device=dev))
    with pytest.raises(ValueError, match="do: dtype"):
        la.long_attention_bwd(qkv, do.float(), 1, 64)
    with pytest.raises(ValueError, match="do: shape"):
        la.long_attention_bwd(qkv, do[:, :32].contiguous(), 1, 64)
    with pytest.raises(ValueError, match="qkv dtype"):
        la.long_attention_bwd(qkv.half(), do.half(), 1, 64)
    with pytest.raises(ValueError, match="do: dtype"):  # f32 qkv takes an f32 do
        la.long_attention_bwd(qkv.float(), do, 1, 64)
    assert la.long_attention_bwd.launches == before


# ---------------------------------------------------------------------------
# K7 (fused quantize GEMM), K8 (scale-after-dot attention), K9a / K9b
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,x_dt,out_dt,per_channel,qmax", [
    (6272, 768, 384, "f32", "f32", False, 255.0), (6304, 384, 1152, "bf16", "bf16", True, 255.0),
    (6304, 1536, 384, "f32", "bf16", True, 127.0), (37, 128, 256, "bf16", "f32", False, 127.0),
    # K = 32 (mod 64), which JAX's gate admits, also at a ragged M
    (8, 96, 128, "f32", "f32", False, 255.0), (6304, 480, 384, "bf16", "bf16", True, 255.0),
    (394, 96, 384, "bf16", "f32", True, 255.0), (394, 480, 640, "f32", "bf16", False, 127.0),
    # K past the strip's 1,536 bytes: two chunks
    (300, 1664, 256, "f32", "f32", True, 255.0),
])
def test_fused_quantize_matmul(dev, m, k, n, x_dt, out_dt, per_channel, qmax):
    """K7 (qvt_quantize_gemm, TMA + wgmma) against its plain version:
    identical, f32 and bf16 inputs and outputs, both weight-scale kinds,
    both grids, ragged M, K = 32 (mod 64), a unit past N, K in two chunks;
    the packed weight given (``w_t``) or packed by the wrapper; two
    launches identical."""
    from qat_vit_tpu_torch.ops import pallas_gemm as pg

    rng = np.random.default_rng(m + k)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    x = torch.from_numpy(rng.normal(0, 1.5, (m, k)).astype(np.float32)).to(dev).to(dts[x_dt])
    layer = _layer(rng, k, n, dev, per_channel)
    kw = dict(x_scale=torch.tensor(4.0 / qmax), x_zero_point=torch.tensor(100.0),
              w_scale=layer["w_scale"], w_colsum=layer["w_colsum"], bias=layer["bias"],
              x_quant_max=qmax, out_dtype=dts[out_dt])
    before = pg.fused_quantize_matmul.launches
    got = pg.fused_quantize_matmul(x, layer["w_int8"], **kw, w_t=layer["w_int8_t"])
    assert pg.fused_quantize_matmul.launches == before + 1
    _same(got, pg.fused_quantize_matmul_plain(x, layer["w_int8"], **kw))
    _same(pg.fused_quantize_matmul(x, layer["w_int8"], **kw), got)


def test_fused_quantize_matmul_raises(dev):
    """Where JAX's gate admits K 96 (K = 32 mod 64) K7 runs, through
    quantized_dense too, identical to its plain version; a K the kernel does
    not take (not a multiple of 16) and bad inputs raise before any launch."""
    from qat_vit_tpu_torch.ops import pallas_gemm as pg
    from qat_vit_tpu_torch.ops.quantized_matmul import quantized_dense

    rng = np.random.default_rng(9)
    layer = _layer(rng, 96, 128, dev)
    x = torch.from_numpy(rng.normal(0, 1.5, (8, 96)).astype(np.float32)).to(dev)
    kw = dict(x_scale=0.02, x_zero_point=100.0, w_scale=layer["w_scale"],
              w_colsum=layer["w_colsum"], bias=layer["bias"])
    before = pg.fused_quantize_matmul.launches
    assert pg.fused_quantize_matmul_available(x.shape, layer["w_int8"].shape)
    _same(pg.fused_quantize_matmul(x, layer["w_int8"], **kw),
          pg.fused_quantize_matmul_plain(x, layer["w_int8"], **kw))
    in_q = {"scale": 0.02, "zero_point": 100.0}
    _same(quantized_dense(x, layer, in_q, use_pallas=True),
          pg.fused_quantize_matmul_plain(x, layer["w_int8"], **kw))
    assert pg.fused_quantize_matmul.launches == before + 2
    bad = _layer(rng, 100, 128, dev)
    with pytest.raises(ValueError, match="unsupported K"):
        pg.fused_quantize_matmul(torch.zeros(8, 100, device=dev), bad["w_int8"],
                                 **{**kw, "w_colsum": bad["w_colsum"]})
    layer = _layer(rng, 128, 128, dev)
    with pytest.raises(ValueError, match="f32 or bf16"):
        pg.fused_quantize_matmul(torch.zeros(8, 128, dtype=torch.float16, device=dev),
                                 layer["w_int8"], **{**kw, "w_colsum": layer["w_colsum"]})
    assert pg.fused_quantize_matmul.launches == before + 2


@pytest.mark.parametrize("b,n,n_valid", [(2, 2305, 2305), (1, 4096, 4090)])
def test_long_attention_bwd_f32_on_kernel_b(dev, b, n, n_valid):
    """K5b in f32 on kernel B's rows and keys passes (K5b's arithmetic; R 8
    at 2,305 tokens, R 4 at 4,096) identical to its plain version at
    OWLv2-pruned's width (9 heads of 64), padded queries included; two
    launches identical; two kernels per call."""
    from qat_vit_tpu_torch.ops import long_attention as la

    rng = np.random.default_rng(n)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * 9 * 64)).astype(np.float32)).to(dev)
    do = torch.from_numpy(rng.normal(0, 1, (b, n, 9 * 64)).astype(np.float32)).to(dev)
    before = la.long_attention_bwd.launches
    got = la.long_attention_bwd(qkv, do, 9, 64, n_valid=n_valid)
    assert la.long_attention_bwd.launches == before + 2
    _same(got, la.long_attention_bwd_plain(qkv, do, 9, 64, n_valid=n_valid))
    _same(la.long_attention_bwd(qkv, do, 9, 64, n_valid=n_valid), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,heads,hd,n_valid", [(32, 197, 6, 64, 197), (4, 32, 2, 64, 17),
                                                  (2, 50, 4, 32, 41), (2, 130, 2, 128, 130)])
def test_flash_attention(dev, dtype, b, n, heads, hd, n_valid):
    """K8 against its plain version, masked keys: in f32
    (``qvt_flash_attention_f32``: explicit multiply-then-add, no contracted
    FMA) identical; in bf16 (``qvt_flash_attention_mma``, tensor cores)
    within the tolerance of ``tc_errors`` against its plain version and the
    f64 math; two launches identical."""
    _check_flash_attention(dev, dtype, b, n, heads, hd, n_valid)


def _check_flash_attention(dev, dtype, b, n, heads, hd, n_valid):
    rng = np.random.default_rng(n + hd)
    qkv = torch.from_numpy(rng.normal(0, 1.5, (b, n, 3 * heads * hd)).astype(np.float32))
    qkv = qkv.to(dev).to(dtype)
    before = fa.flash_attention_qkv.launches
    got = fa.flash_attention_qkv(qkv, heads, hd, n_valid=n_valid)
    assert fa.flash_attention_qkv.launches == before + 1
    plain = fa.flash_attention_qkv_plain(qkv, heads, hd, n_valid=n_valid)
    if dtype == torch.float32:
        _same(got, plain)
    else:
        assert_tc_close(got, plain, la.long_attention_f64(qkv, heads, hd, n_valid=n_valid)[0], 1)
    _same(got, fa.flash_attention_qkv(qkv, heads, hd, n_valid=n_valid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,heads,hd,n_valid", [(2, 577, 6, 64, 577), (1, 1025, 4, 64, 1000),
                                                  (1, 577, 2, 128, 570)])
def test_flash_attention_past_the_tile(dev, dtype, b, n, heads, hd, n_valid):
    """K8 past the CUDA-core tile's plan of the earlier kernel (789 / 420
    tokens at hd 64 in bf16 / f32, 416 / 208 at hd 128): ViT-S/16 at 384 px
    (577 tokens) and N 1,025, as :func:`test_flash_attention` holds it."""
    _check_flash_attention(dev, dtype, b, n, heads, hd, n_valid)


def test_flash_attention_gate_raises(dev):
    """K8 takes kernel A's plans: 421 f32 tokens at hd 64 (past the earlier
    CUDA-core tile) run, as does bf16; an f32 N past kernel A's plan
    (39,081 at hd 128), hd 60 and a float16 qkv raise, and nothing
    launches."""
    before = fa.flash_attention_qkv.launches
    qkv = torch.zeros(1, 421, 3 * 64, device=dev)
    with pytest.raises(ValueError, match="unsupported"):
        fa.flash_attention_qkv(torch.zeros(1, 39_081, 3 * 128, device=dev), 1, 128)
    with pytest.raises(ValueError, match="unsupported"):
        fa.flash_attention_qkv(torch.zeros(1, 17, 3 * 60, device=dev), 1, 60)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_qkv(qkv.half(), 1, 64)
    assert fa.flash_attention_qkv.launches == before
    fa.flash_attention_qkv(qkv, 1, 64)
    fa.flash_attention_qkv(qkv.to(torch.bfloat16), 1, 64)
    assert fa.flash_attention_qkv.launches == before + 2


def _ptq_export(dev, name, px, **kw):
    """(cfg, PTQ export on the card, 8 images): model ``name`` with ``kw``
    in its config, random init from seed 0, calibrated on the images."""
    from qat_vit_tpu_torch.models.registry import create_model
    from qat_vit_tpu_torch.serve.calibrate import ptq_convert
    from qat_vit_tpu_torch.serve.int8_vit import export_to_device

    m = create_model(name, qat_wrapper=True, generator=torch.Generator().manual_seed(0),
                     device=dev, **kw)
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (8, px, px, 3))
                         .astype(np.float32)).to(dev)
    return m.cfg, export_to_device(ptq_convert(m.module.state_dict(), [x], m.cfg), dev), x


@pytest.fixture(scope="module", params=["micro", "vit_s_depth2"])
def serve_export(dev, request):
    """A PTQ export on the card: the micro ViT, or ViT-S/16 at full width
    with depth cut to 2 (random init from seed 0, one batch of 8 images)."""
    if request.param == "micro":
        return _ptq_export(dev, "vit_micro_test", 32)
    return _ptq_export(dev, "vit_small_patch16_224_student", 224, depth=2)


def test_from_checkpoint_round_trip(dev, serve_export, tmp_path):
    """The export written by ``save_checkpoint`` and served back by
    ``Int8Predictor.from_checkpoint`` on the card: the same logits as the
    in-memory export through the same predictor, K2d launched."""
    from qat_vit_tpu_torch.serve.predictor import Int8Predictor
    from qat_vit_tpu_torch.utils.checkpoint import save_checkpoint

    cfg, qp, _ = serve_export

    def unpacked(tree):  # the export as convert_vit gives it: no packed weights
        if not isinstance(tree, dict):
            return tree
        return {k: unpacked(v) for k, v in tree.items() if k != "w_int8_t"}

    export = unpacked(qp)
    path = str(tmp_path / "export.msgpack")
    save_checkpoint(path, export)
    images = np.random.default_rng(7).integers(0, 256, (10, 32, 32, 3), dtype=np.uint8)
    want = Int8Predictor(export, cfg, batch_size=8, device=dev).logits(images)
    fs.ln_quantize.launches = 0
    pred = Int8Predictor.from_checkpoint(path, cfg, device=dev, batch_size=8)
    np.testing.assert_array_equal(pred.logits(images), want)
    assert fs.ln_quantize.launches > 0
    assert pred.qparams["blocks"]["0"]["qkv"]["w_colsum"].dtype == torch.int32


def test_megablock_modes_match_the_chain(dev, serve_export, monkeypatch):
    """K9a (one cooperative launch per block) and K9b (one per forward):
    logits identical to the megamodel kernel chain's (K9 runs its stage
    code, K3's tensor-core attention tile included), which is identical to
    the plain chain with K3's attention; 1 launch per block and 1 per
    forward, none of the chain's kernels; two launches identical."""
    from qat_vit_tpu_torch.ops import block_kernel as bk
    from qat_vit_tpu_torch.serve import int8_vit
    from qat_vit_tpu_torch.serve.int8_vit import int8_apply

    cfg, qp, x = serve_export
    bf = torch.bfloat16
    chain = int8_apply(qp, x, cfg, compute_dtype=bf, fused="megamodel")
    with monkeypatch.context() as mp:
        mp.setattr(int8_vit, "PLAIN_OPS", _plain_ops_with_k3())
        _same(chain, int8_apply(qp, x, cfg, compute_dtype=bf, fused="megamodel_plain"))
    for mode, wrapper, want in (("megablock:4:tight", bk.megablock_forward, cfg.depth),
                                ("megamodel_res:4:tight", bk.megamodel_res_forward, 1)):
        before, attn = wrapper.launches, fa.fused_attention_qkv.launches
        got = int8_apply(qp, x, cfg, compute_dtype=bf, fused=mode)
        torch.cuda.synchronize()
        assert wrapper.launches == before + want
        assert fa.fused_attention_qkv.launches == attn
        _same(got, chain)
        _same(got, int8_apply(qp, x, cfg, compute_dtype=bf, fused=mode))


def _check_k9_blocks(cfg, qp, x_img):
    """At block level, f32 and bf16 streams, all keys and masked ones: K9a's
    (block 0) and K9b's (both blocks) x and zq are the kernel chain's bit
    for bit, and the plain chain's with K3 as its attention stage."""
    from qat_vit_tpu_torch.ops import block_kernel as bk
    from qat_vit_tpu_torch.serve.int8_vit import _embed

    kw = dict(num_heads=cfg.num_heads, head_dim=cfg.head_dim, eps=cfg.layer_norm_eps)
    for dt in (torch.bfloat16, torch.float32):
        x = _embed(qp, x_img, cfg, dt, fs.int8_dense)
        blk0 = qp["blocks"]["0"]
        zq = fs.ln_quantize(x, blk0["norm1"], blk0["norm1"]["out_q"], eps=cfg.layer_norm_eps)
        n = x.shape[1]
        nxt = qp["blocks"]["1"]["norm1"]
        twin = _plain_ops_with_k3()
        for nv in (n, n - 3):  # masked keys (n_valid < N) through the same stages
            one = bk.megablock_forward(zq, x, blk0, nxt, n_valid=nv, **kw)
            _same(one, bk.block_forward(zq, x, blk0, nxt, n_valid=nv, **kw))
            _same(one, bk.block_forward(zq, x, blk0, nxt, n_valid=nv, ops=twin, **kw))
            whole = bk.megamodel_res_forward(zq, x, qp["blocks"], qp["norm"], depth=2,
                                             n_valid=nv, **kw)
            _same(whole, bk.model_forward(zq, x, qp["blocks"], qp["norm"], depth=2, n_valid=nv,
                                          **kw))
            _same(whole, bk.model_forward(zq, x, qp["blocks"], qp["norm"], depth=2, n_valid=nv,
                                          ops=twin, **kw))


def test_megablock_blocks_match_the_chain(dev, serve_export):
    """At block level (:func:`_check_k9_blocks`) on the micro ViT and ViT-S."""
    _check_k9_blocks(*serve_export)


# (D, heads, MLP): hd 96 (K3's 128-wide tile) with K % 64 = 32 in every
# GEMM (D 480; MLP 1,568 in fc2) and K2c's 32-row tiles; ViT-B's width
# (32-row tiles); ViT-L's (16-row tiles); D 1,536, whose K2c tile takes more
# shared memory than the GEMM stages (MLP 3,072: K9b's weight gate at depth 2)
K9_WIDER = [(480, 5, 1568), (768, 12, 3072), (1024, 16, 4096), (1536, 24, 3072)]


@pytest.mark.parametrize("d,heads,mlp", K9_WIDER)
def test_megablock_wider_forms_match_the_chain(dev, d, heads, mlp):
    """K9's forms past ViT-S's (each a depth-2 export at 224 px, 197
    tokens, random init from seed 0): as :func:`_check_k9_blocks` holds
    them, and the launcher's block shape is ``megablock_plan``'s."""
    from qat_vit_tpu_torch.ops import block_kernel as bk

    cfg, qp, x_img = _ptq_export(dev, "vit_small_patch16_224_student", 224, depth=2,
                                 embed_dim=d, num_heads=heads, mlp_ratio=mlp / d)
    assert (cfg.embed_dim, cfg.head_dim, cfg.mlp_dim) == (d, d // heads, mlp)
    assert bk.megablock_shapes_ok(cfg.seq_len, heads, cfg.head_dim, mlp)
    rows, resident, _, smem = bk.megablock_plan(cfg.seq_len, d, cfg.head_dim)
    assert (rows, smem > bk.megablock_plan(197, 384, 64)[3]) == {
        480: (32, False), 768: (32, False), 1024: (16, False), 1536: (16, True)}[d]
    _check_k9_blocks(cfg, qp, x_img)


def test_megablock_residency_is_the_plan(dev):
    """``qvt_megablock_residency`` (the C plan and the occupancy API) equals
    ``megablock_plan`` (its Python mirror, which the gate reads): threads,
    shared memory, K2c's rows and K3's form, over widths, head dims and
    token counts, both x dtypes; one block per SM on every SM."""
    import ctypes
    from itertools import product

    from qat_vit_tpu_torch import _build
    from qat_vit_tpu_torch.ops import block_kernel as bk

    out = (ctypes.c_int * 6)()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, (h, hd), x_bf16 in product((1, 197, 577, 901, 2305),
                                      ((6, 64), (5, 96), (12, 64), (16, 64), (24, 64), (3, 128),
                                       (16, 80), (4, 8)), (0, 1)):
        _build.load().call("qvt_megablock_residency", n, h, hd, x_bf16, ctypes.addressof(out))
        rows, resident, _, smem = bk.megablock_plan(n, h * hd, hd)
        assert list(out) == [bk.K9_MIN_BLOCKS, sms, bk.K9_THREADS, smem, rows, int(resident)], (
            n, h, hd, x_bf16)



def test_megamodel_res_gate_and_launch_errors_raise(dev, serve_export, monkeypatch):
    """K9b above its weight gate raises naming megamodel; a refused
    cooperative launch (a shared-memory plan past the limit) surfaces its
    cudaError as an exception; nothing is counted."""
    import ctypes

    from qat_vit_tpu_torch import _build
    from qat_vit_tpu_torch.ops import block_kernel as bk
    from qat_vit_tpu_torch.serve.int8_vit import int8_apply

    cfg, qp, x = serve_export
    monkeypatch.setattr(bk, "MEGAMODEL_RES_MAX_WEIGHT_BYTES",
                        bk.stacked_weight_bytes(qp["blocks"], cfg.depth) - 1)
    before = bk.megamodel_res_forward.launches
    with pytest.raises(NotImplementedError, match="fused='megamodel'"):
        int8_apply(qp, x, cfg, compute_dtype=torch.bfloat16, fused="megamodel_res")
    assert bk.megamodel_res_forward.launches == before
    null = ctypes.c_void_p(0)
    with pytest.raises(RuntimeError, match="qvt_megablock failed to launch"):
        # D 2,560: K2c's 16-row tile alone asks past the limit
        _build.load().call("qvt_megablock", null, 1, *([null] * 9), 1, 197, 40, 64, 1536,
                           197, 0, 0.125, 255.0, 1e-6, null)
    # the error was cleared: the next launch reports its own status (success)
    fs.ln_quantize(torch.zeros(1, 4, 384, device=dev), _ln(np.random.default_rng(0), 384, dev),
                   OUT_Q)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the f32 forms of the training attention (K1's kernels A and B, K5a, K5b)
# ---------------------------------------------------------------------------

# ViT-S at batch 8 and 256, an odd N, N 512 at 6 heads of 64 and of 128
# (kernel B's rows pass at 16 rows per block there), 1,248 at one head of
# 128 (kernel A at 16 rows, kernel B at 8)
F32_ATTN_SHAPES = [(8, 197, 6, 64, 197), (4, 32, 2, 64, 17), (2, 197, 12, 64, 190),
                   (2, 50, 4, 32, 50), (2, 512, 6, 64, 500), (2, 512, 6, 128, 512),
                   (1, 1248, 1, 128, 1248), (256, 197, 6, 64, 197), (3, 333, 6, 64, 301)]


@pytest.mark.parametrize("fq", [False, True])
@pytest.mark.parametrize("b,n,heads,hd,n_valid", F32_ATTN_SHAPES)
def test_attention_fwd_f32(dev, b, n, heads, hd, n_valid, fq):
    """Kernel A in f32 (with and without the in-kernel fake-quant, which
    rounds nothing back): identical to its plain version, f32 out, and two
    launches identical."""
    qkv, _, qs = _qkv_case(dev, b, n, heads, hd, n + heads + 1)
    qkv = qkv.float() + 1e-3 * torch.randn(qkv.shape, device=dev,
                                           generator=torch.Generator(dev).manual_seed(n))
    kw = {"qs": qs, "in_fq": (0, 255)} if fq else {}
    before = fa.attention_fwd.launches
    got = fa.attention_fwd(qkv, heads, hd, n_valid=n_valid, **kw)
    assert fa.attention_fwd.launches == before + 1 and got.dtype == torch.float32
    _same(got, fa.attention_fwd_plain(qkv, heads, hd, n_valid=n_valid, **kw))
    _same(got, fa.attention_fwd(qkv, heads, hd, n_valid=n_valid, **kw))


@pytest.mark.parametrize("fq", [False, True])
@pytest.mark.parametrize("b,n,heads,hd,n_valid", F32_ATTN_SHAPES)
def test_attention_bwd_f32(dev, b, n, heads, hd, n_valid, fq):
    """Kernel B in f32 (with and without the STE mask): identical dqkv, and
    two launches identical."""
    qkv, do, qs = _qkv_case(dev, b, n, heads, hd, 2 * n + heads + 1)
    qkv, do = qkv.float() * 1.01, do.float() * 0.99
    kw = {"qs": qs, "in_fq": (0, 255)} if fq else {}
    before = fat.attention_bwd.launches
    got = fat.attention_bwd(qkv, do, heads, hd, n_valid=n_valid, **kw)
    assert fat.attention_bwd.launches == before + 1 and got.dtype == torch.float32
    _same(got, fat.attention_bwd_plain(qkv, do, heads, hd, n_valid=n_valid, **kw))
    _same(got, fat.attention_bwd(qkv, do, heads, hd, n_valid=n_valid, **kw))
    if fq:
        assert (got == 0).any() and (got != 0).any()


def test_attention_f32_gate(dev):
    """The f32 kernels take fewer rows per block as N grows: the gate takes
    JAX's N range, and the wrapper raises, launching nothing, only past the
    rows pass's plan at one row per block (N 18,473 at hd 128)."""
    assert fat.attention_train_available(6, 64, 204, torch.float32)
    assert fat.attention_train_available(6, 64, 512, torch.float32)
    assert not fat.attention_train_available(6, 64, 513, torch.float32)
    qkv = torch.zeros(1, 18473, 3 * 128, device=dev)
    before = fat.attention_bwd.launches
    with pytest.raises(ValueError, match="unsupported"):
        fat.attention_bwd(qkv, torch.zeros(1, 18473, 128, device=dev), 1, 128)
    assert fat.attention_bwd.launches == before


@pytest.mark.parametrize("b,n,heads,hd,n_valid", [(2, 197, 6, 64, 197), (1, 2305, 9, 64, 2305),
                                                  (2, 300, 3, 32, 290), (1, 130, 2, 128, 130),
                                                  (1, 520, 2, 72, 500)])
def test_long_attention_f32(dev, b, n, heads, hd, n_valid):
    """K5a and K5b in f32 (64-key tiles): identical to their plain versions,
    forward and dqkv; padded query and key rows of dqkv are zero."""
    from qat_vit_tpu_torch.ops import long_attention as la

    rng = np.random.default_rng(n + hd + 1)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32)).to(dev)
    do = torch.from_numpy(rng.normal(0, 1, (b, n, heads * hd)).astype(np.float32)).to(dev)
    before = la.long_attention_qkv.launches, la.long_attention_bwd.launches
    out = la.long_attention_qkv(qkv, heads, hd, n_valid=n_valid)
    got = la.long_attention_bwd(qkv, do, heads, hd, n_valid=n_valid)
    assert (la.long_attention_qkv.launches, la.long_attention_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    assert out.dtype == got.dtype == torch.float32
    _same(out, la.long_attention_qkv_plain(qkv, heads, hd, n_valid=n_valid))
    _same(got, la.long_attention_bwd_plain(qkv, do, heads, hd, n_valid=n_valid))
    assert not got[:, n_valid:].any() and got[:, :n_valid].any()


@pytest.mark.parametrize("b,n,heads,hd,n_valid", [(2, 2305, 9, 64, 2305), (1, 7000, 2, 64, 6990)])
def test_long_attention_f32_forward(dev, b, n, heads, hd, n_valid):
    """K5a in f32 on kernel A's f32 kernel at OWLv2's 2,305 tokens and at
    7,000, past the earlier kernel's plan (6,048 at hd 64): identical to
    its plain version, two launches identical."""
    rng = np.random.default_rng(n + hd + 2)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32)).to(dev)
    before = la.long_attention_qkv.launches
    out = la.long_attention_qkv(qkv, heads, hd, n_valid=n_valid)
    assert la.long_attention_qkv.launches == before + 1 and out.dtype == torch.float32
    _same(out, la.long_attention_qkv_plain(qkv, heads, hd, n_valid=n_valid))
    _same(out, la.long_attention_qkv(qkv, heads, hd, n_valid=n_valid))


@pytest.mark.parametrize("long", [False, True])
def test_attention_train_f32_autograd(dev, long):
    """The f32 training pairs on the kernels vs the same Functions through
    the plain versions (``reference_impl``): forward and dqkv identical."""
    from qat_vit_tpu_torch.ops import long_attention as la

    heads, hd, n = (9, 64, 2305) if long else (6, 64, 197)
    rng = np.random.default_rng(13)
    qkv = torch.from_numpy(rng.normal(0, 1, (1, n, 3 * heads * hd)).astype(np.float32)).to(dev)
    do = torch.from_numpy(rng.normal(0, 1, (1, n, heads * hd)).astype(np.float32)).to(dev)

    def run():
        x = qkv.clone().requires_grad_(True)
        out = la.long_attention_train(x, heads, hd) if long else fat.attention_train(x, heads, hd)
        (out * do).sum().backward()
        return out.detach(), x.grad

    out_k, grad_k = run()
    with reference_impl():
        out_p, grad_p = run()
    _same(out_k, out_p)
    _same(grad_k, grad_p)


# ---------------------------------------------------------------------------
# K6 with int8 scores: PLAIN_Q8 and qvt_attention_long_q8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,d", [(8 * 2305, 576), (2 * 2305, 576), (37, 64), (394, 384),
                                 (37, 480), (1, 96)])
def test_int8_dense_q8(dev, m, d):
    """The PLAIN_Q8 epilogue: the bf16 y and the int8 q/k columns (quantized
    from the f32 y) identical to the plain version; y identical to PLAIN's;
    a layer without the packed weight raises."""
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.integers(-128, 128, (m, d), dtype=np.int8)).to(dev)
    layer = _layer(rng, d, 3 * d, dev)
    before = fs.int8_dense_q8.launches
    got = fs.int8_dense_q8(x, layer, IN_Q, OUT_Q)
    assert fs.int8_dense_q8.launches == before + 1
    _same(got, fs.int8_dense_q8_plain(x, layer, IN_Q, OUT_Q))
    _same(got[0], fs.int8_dense(x, layer, IN_Q))
    assert got[1].shape == (m, 2 * d)
    with pytest.raises(ValueError, match="w_int8_t"):
        fs.int8_dense_q8(x, _without_packed(layer), IN_Q, OUT_Q)


@pytest.mark.parametrize("b,n,heads,hd,n_valid", [(8, 2305, 9, 64, 2305), (2, 2305, 9, 64, 2305),
                                                  (2, 197, 6, 64, 190),
                                                  (1, 300, 3, 32, 300), (1, 130, 2, 128, 129)])
def test_long_attention_q8(dev, b, n, heads, hd, n_valid):
    """qvt_attention_long_q8_mma (int8 score dots on mma.sync, exact in
    int32) against its plain version (the integer dot exact in f64): within
    K6a's int8 bound."""
    from qat_vit_tpu_torch.ops import long_attention as la

    rng = np.random.default_rng(n + heads)
    qk8 = torch.from_numpy(rng.integers(-128, 128, (b, n, 2 * heads * hd), dtype=np.int8)).to(dev)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32))
    qkv = qkv.to(dev).to(torch.bfloat16)
    out_q = {"scale": torch.tensor(0.05), "zero_point": torch.tensor(131.0)}
    before = la.long_attention_q8.launches
    got = la.long_attention_q8(qk8, qkv, heads, hd, out_q=out_q, n_valid=n_valid)
    assert la.long_attention_q8.launches == before + 1
    _int8_close(got, la.long_attention_q8_plain(qk8, qkv, heads, hd, out_q=out_q,
                                                n_valid=n_valid))


def test_i8_chain_matches_plain(dev, owlv2_export, monkeypatch):
    """The ``i8`` chain on OWLv2-pruned (full width, depth 2): five launches
    per block (PLAIN_Q8 and the int8-score attention in place of PLAIN and
    attention_long_q), outputs identical to its plain twin with the kernels'
    attention stage and equal between megablock_long and megamodel_long."""
    from qat_vit_tpu_torch.ops import long_attention as la
    from qat_vit_tpu_torch.serve import int8_vit
    from qat_vit_tpu_torch.serve.int8_detect import make_int8_detect_forward

    cfg, qp, x = owlv2_export
    q = torch.from_numpy(np.random.default_rng(8).normal(0, 1, (1, 4, 512))
                         .astype(np.float32)).to(dev)
    wrappers = (fs.int8_dense, fs.int8_dense_q8, la.long_attention_q8, la.long_attention_q)
    before = [w.launches for w in wrappers]
    out = make_int8_detect_forward(cfg, dev, fused="megamodel_long:512:256:i8")(qp, x, q)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 2, 2, 0]
    monkeypatch.setattr(int8_vit, "LONG_PLAIN_OPS", _plain_ops_with_kernel_attention())
    plain = make_int8_detect_forward(cfg, dev, fused="megamodel_long_plain:512:256:i8")(qp, x, q)
    block = make_int8_detect_forward(cfg, dev, fused="megablock_long:512:256:i8:su5")(qp, x, q)
    for k in out:
        _same(out[k], plain[k])
        _same(out[k], block[k])
