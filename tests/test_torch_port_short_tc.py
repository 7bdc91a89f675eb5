"""The numerics of the short-sequence attention on the tensor cores, rehearsed on the CPU.

K3 (``qvt_attention_q_mma``) and the bf16 kernel A (``qvt_attention_fwd_mma``),
both in ``csrc/attention_q_mma.cu``, run two passes over 64-key tiles on
``mma.sync``: each row's running max m and sum l in f32, then the
normalised p = exp2((s - m)·log2e)·(1/l) rounded to bf16 for p·v; K3
quantizes o to shifted int8, kernel A rounds it to bf16, with the qkv
fake-quant (``in_fq``) applied to q, k and v as they are staged. They sum in
the tensor cores' order, so on the card K3 is held to the int8 bound (max
|diff| 1, >= 99.9% identical) and kernel A to ``long_attention.tc_errors``
(2^-7 (1 + |plain|), twice the plain version's distance from the f64 math).

This file holds a Python model of that algorithm (K6a's two passes,
``tests/test_torch_port_long_tc.two_pass_q`` / ``two_pass_forward``, with
the fake-quant prologue) to those bounds against the index-order plain
versions (``fused_attention_qkv_plain``, ``attention_fwd_plain``) and
against JAX's ``fused_attention_qkv`` and ``attention_train`` /
``attention_train_fq`` in interpret mode, from N 1 to the gate's edge, at
n_valid < N and hd 8 to 128; runs a micro ViT chain with the model as its
attention stage against JAX's ``int8_apply(fused="megamodel")``; checks the
wrappers' launch arguments against a recording stand-in for the kernel
library; and pins the gate. Inputs are numpy, seeded, and go to both
packages.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qat_vit_tpu.ops.flash_attention import fused_attention_qkv as jax_fused_attention
from qat_vit_tpu.ops.flash_attention_train import attention_train as jax_attention_train
from qat_vit_tpu.ops.flash_attention_train import attention_train_fq as jax_attention_train_fq
from qat_vit_tpu.serve.int8_vit import int8_apply as jax_int8_apply
from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops import flash_attention as fa
from qat_vit_tpu_torch.ops import long_attention as la
from qat_vit_tpu_torch.ops.quantized_matmul import f32
from qat_vit_tpu_torch.quant.fake_quant import fake_quantize_values
from qat_vit_tpu_torch.serve.int8_vit import int8_apply
from tests.test_torch_port_long_tc import Q_OUT, _qkv_do, two_pass_forward, two_pass_q
from tests.test_torch_port_slice import _jax_interpret, _int8_close
from tests.test_torch_port_slice import export  # noqa: F401 (a module fixture)


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
FQ = (4.2 / 255, 127.0)  # a qkv grid whose ends clip ~3% of N(0, 1)
IN_FQ = (0, 255)
# the card's bound on an int8-out chain against the exact f32 path (chip_smoke.EXACT_REL_L2)
EXACT_REL_L2 = 0.2


def short_k3(qkv, h, hd, out_q, quant_max=255.0, n_valid=None):
    """K3's algorithm: the two passes over 64-key tiles, o quantized."""
    return two_pass_q(qkv, h, hd, out_q, quant_max, n_valid)


def short_a(qkv, h, hd, qs=None, in_fq=None, n_valid=None):
    """Kernel A's algorithm: the fake-quant prologue (f32, half to even,
    clip, back to bf16) on q, k and v, then the two passes, o in bf16."""
    if in_fq is not None:
        qkv = fake_quantize_values(qkv, qs[0], qs[1], in_fq[0], in_fq[1])
    return two_pass_forward(qkv, h, hd, n_valid)


def assert_tc_close(got, plain, ref):
    ok, errs = la.tc_errors(got, plain, ref, 1)
    assert ok, errs


# (b, n, heads, hd, n_valid): N 1 and 5, the micro ViT's 17, ViT-S's 197 (6
# and 12 heads), ragged N with masked keys, hd 8, 32, 72 and 128; and the
# gate's edge at hd 64 (789) and hd 128 (416)
SHAPES = [(2, 1, 2, 64, 1), (3, 5, 2, 64, 4), (2, 17, 2, 64, 17), (2, 197, 6, 64, 197),
          (1, 197, 12, 64, 150), (2, 33, 3, 8, 33), (2, 97, 2, 32, 90), (1, 130, 2, 72, 130),
          (1, 77, 2, 128, 77)]
EDGES = [(1, 789, 1, 64, 789), (1, 416, 1, 128, 400)]


@pytest.mark.parametrize("b,n,h,hd,n_valid", SHAPES + EDGES)
def test_k3_model_within_the_int8_bound_of_plain(b, n, h, hd, n_valid):
    """K3's model against ``fused_attention_qkv_plain`` (index-order sums,
    exp in f64): max |diff| 1 and >= 99.9% identical, the card's bound; only
    the sum order and exp2 against the f64 exp differ."""
    qkv, _ = _qkv_do(b, n, h, hd, n + 7 * hd)
    got = short_k3(qkv, h, hd, Q_OUT, n_valid=n_valid)
    want = fa.fused_attention_qkv_plain(qkv, h, hd, out_q=Q_OUT, n_valid=n_valid)
    assert got.dtype == want.dtype == torch.int8 and got.shape == want.shape
    _int8_close(got.numpy(), want.numpy())
    if n >= 17:
        assert len(torch.unique(want)) > 20  # o spans many grid steps


@pytest.mark.parametrize("b,n,h,hd,n_valid,fq", [
    (*shape, fq) for shape in SHAPES for fq in (False, True)] + [(*e, True) for e in EDGES])
def test_kernel_a_model_within_tolerance_of_plain(b, n, h, hd, n_valid, fq):
    """Kernel A's model, with and without the fake-quant prologue (at the
    gate's edges with it, the superset), against ``attention_fwd_plain``:
    within 2^-7 (1 + |plain|) everywhere and at most twice the plain
    version's rel L2 from the f64 math of the same fake-quantized qkv."""
    qkv, _ = _qkv_do(b, n, h, hd, 3 * n + hd)
    kw = {"qs": torch.tensor(FQ), "in_fq": IN_FQ} if fq else {}
    got = short_a(qkv, h, hd, n_valid=n_valid, **kw)
    want = fa.attention_fwd_plain(qkv, h, hd, n_valid=n_valid, **kw)
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape
    assert_tc_close(got, want, la.long_attention_f64(qkv, h, hd, n_valid=n_valid, **kw)[0])
    if fq:  # the grid clips: the prologue changes the values
        assert not torch.equal(fake_quantize_values(qkv, *kw["qs"], *IN_FQ), qkv)


@pytest.mark.parametrize("b,n,h", [(2, 17, 2), (1, 197, 6)])
def test_k3_model_matches_jax(b, n, h):
    """K3's model against JAX's ``fused_attention_qkv(out_q=…)`` in
    interpret mode (N padded to 128 there, the padding masked): the int8
    bound."""
    hd = 64
    qkv, _ = _qkv_do(b, n, h, hd, 5 * n)
    out_q = {"scale": np.float32(f32(Q_OUT["scale"])), "zero_point": np.float32(128.0)}
    want = jax_fused_attention(jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16), h, hd,
                               block_b=b, out_q=out_q, interpret=True)
    _int8_close(short_k3(qkv, h, hd, Q_OUT).numpy(), np.asarray(want))


@pytest.mark.parametrize("fq", [False, True])
def test_kernel_a_model_matches_jax(fq):
    """Kernel A's model against JAX's training forward (``attention_train``,
    ``attention_train_fq``) in interpret mode at the micro ViT's 17 tokens:
    JAX's output in the plain version's place, the same tolerance."""
    b, n, h, hd = 3, 17, 2, 64
    qkv, _ = _qkv_do(b, n, h, hd, 17)
    jq = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16)
    if fq:
        jout = jax_attention_train_fq(jq, jnp.asarray([FQ], jnp.float32), h, hd, *IN_FQ, 4, True)
    else:
        jout = jax_attention_train(jq, h, hd, 4, True)
    want = torch.from_numpy(np.array(jnp.asarray(jout, jnp.float32))).to(BF16)
    kw = {"qs": torch.tensor(FQ), "in_fq": IN_FQ} if fq else {}
    assert_tc_close(short_a(qkv, h, hd, **kw), want, la.long_attention_f64(qkv, h, hd, **kw)[0])


def test_micro_chain_on_the_k3_model_matches_jax(export, monkeypatch):  # noqa: F811
    """The micro ViT's megamodel chain (depth 2, 17 tokens, 2 heads of 64)
    with K3's model as its attention stage, against JAX's
    ``int8_apply(fused="megamodel:2:tight")`` as one jitted interpret call:
    logits within the exact-path bound's rel L2, the same top-1; the model
    ran once per block."""
    jcfg, tcfg, qp_np, qp_t, x = export
    calls = []

    def attention(qkv, h, hd, *, out_q, quant_max=255.0, n_valid=None):
        calls.append(qkv.shape)
        return short_k3(qkv, h, hd, out_q, quant_max, n_valid)

    monkeypatch.setattr(fa, "fused_attention_qkv_plain", attention)
    want = np.asarray(_jax_interpret(
        partial(jax_int8_apply, cfg=jcfg, compute_dtype=jnp.bfloat16, fused="megamodel:2:tight"),
        jax.tree.map(jnp.asarray, qp_np), jnp.asarray(x)))
    got = int8_apply(qp_t, torch.from_numpy(x), tcfg, compute_dtype=BF16,
                     fused="megamodel").numpy()
    assert len(calls) == tcfg.depth and got.shape == want.shape
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= EXACT_REL_L2
    assert (got.argmax(-1) == want.argmax(-1)).all()


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
    monkeypatch.setattr(fa, "use_plain", lambda t: False)
    monkeypatch.setattr(fa, "stream_of", lambda dev: 0)
    return rec


def test_launch_arguments(recorder):
    """What the wrappers hand the kernels (CPU tensors, a recording
    library): K3 and the bf16 kernel A (in_fq off and on) go to the
    tensor-core entry points with the bf16 q scale, kernel A's fake-quant
    pointer, flag and range only with ``in_fq``; f32 kernel A keeps the
    CUDA-core ``qvt_attention_fwd``; one launch each; past the gate, an
    unsupported head dim or dtype, they raise before any launch; K3 takes
    N past the CUDA-core tile's plan (790 at hd 64), as its kernel does."""
    b, n, h, hd = 2, 789, 1, 64
    qkv, _ = _qkv_do(b, n, h, hd, 1)
    scale = float(torch.tensor(hd ** -0.5, dtype=BF16))
    qs = torch.tensor(FQ)
    k3, a = fa.fused_attention_qkv.launches, fa.attention_fwd.launches
    out = fa.fused_attention_qkv(qkv, h, hd, out_q=Q_OUT, n_valid=700)
    name, args = recorder.calls[-1]
    assert name == "qvt_attention_q_mma" and out.dtype == torch.int8
    assert args[:2] == (qkv.data_ptr(), out.data_ptr()) and args[2:7] == (b, n, h, hd, 700)
    assert args[7:11] == (scale, fa.inv_scale(Q_OUT["scale"]), 128.0, 255.0)
    out = fa.attention_fwd(qkv, h, hd)
    name, args = recorder.calls[-1]
    assert name == "qvt_attention_fwd_mma" and out.dtype == BF16
    assert args[:3] == (qkv.data_ptr(), None, out.data_ptr()) and args[3:8] == (b, n, h, hd, n)
    assert args[8:12] == (scale, 0, 0.0, 0.0)
    out = fa.attention_fwd(qkv, h, hd, qs=qs, in_fq=IN_FQ, n_valid=5)
    name, args = recorder.calls[-1]
    assert name == "qvt_attention_fwd_mma" and args[1] == qs.data_ptr()
    assert args[3:8] == (b, n, h, hd, 5) and args[8:12] == (scale, 1, 0.0, 255.0)
    x32 = torch.zeros(1, 197, 3 * 64)
    out = fa.attention_fwd(x32, 1, 64, qs=qs, in_fq=IN_FQ)
    name, args = recorder.calls[-1]
    assert name == "qvt_attention_fwd" and out.dtype == torch.float32
    assert args[8:12] == (float(np.float32(64 ** -0.5)), 1, 0.0, 255.0)
    fa.fused_attention_qkv(torch.zeros(1, 790, 3 * 64, dtype=BF16), 1, 64, out_q=Q_OUT)
    name, args = recorder.calls[-1]
    assert name == "qvt_attention_q_mma" and args[2:7] == (1, 790, 1, 64, 790)
    assert (fa.fused_attention_qkv.launches, fa.attention_fwd.launches) == (k3 + 2, a + 3)
    calls = len(recorder.calls)
    with pytest.raises(ValueError, match="unsupported"):
        fa.fused_attention_qkv(torch.zeros(1, 17, 3 * 60, dtype=BF16), 1, 60, out_q=Q_OUT)
    with pytest.raises(ValueError, match="unsupported"):
        fa.attention_fwd(torch.zeros(1, 17, 3 * 60, dtype=BF16), 1, 60)
    with pytest.raises(ValueError, match="dtype"):  # K3 is bf16-only
        fa.fused_attention_qkv(torch.zeros(1, 17, 3 * 64), 1, 64, out_q=Q_OUT)
    with pytest.raises(ValueError, match="qs: missing"):
        fa.attention_fwd(qkv, h, hd, in_fq=IN_FQ)
    assert len(recorder.calls) == calls


def test_gate_unchanged():
    """The gate of K3 (``attention_fwd_shapes_ok`` in bf16), which K9's
    attention stage now shares with it: hd a multiple of 8 up to 128 and
    any N >= 1, past the edges of the CUDA-core tile that K9 ran before
    (N 789 at hd 64, 416 at hd 128, 1,411 at hd 32, 710 at hd 72, 3,414 at
    hd 8)."""
    for hd in (0, 4, 8, 16, 32, 60, 64, 72, 96, 120, 128, 136):
        for n in (0, 1, 5, 17, 197, 416, 417, 710, 711, 789, 790, 1411, 1412, 3414, 3415):
            want = hd % 8 == 0 and 0 < hd <= 128 and n >= 1
            assert fa.attention_fwd_shapes_ok(n, hd) == want, (n, hd)
    for hd, n in ((64, 789), (128, 416), (32, 1411), (72, 710), (8, 3414)):
        assert fa.attention_fwd_shapes_ok(n, hd) and fa.attention_fwd_shapes_ok(n + 1, hd)
