"""K8 (both forms) and K5a in f32 on kernel A's kernels, rehearsed on the CPU.

K8 (``flash_attention.py::_attention_kernel``) is kernel A's arithmetic with
the f32 score scaled by hd^-0.5 after its dot instead of q before it: its
bf16 form runs ``csrc/attention_q_mma.cu``'s two passes on the tensor cores
(``qvt_flash_attention_mma``), its f32 form ``csrc/attention_f32.cu``'s
register tiles (``qvt_flash_attention_f32``). K5a in f32
(``long_attention.py::_long_attention_kernel``) is kernel A's arithmetic
itself and launches kernel A's f32 kernel (``qvt_attention_fwd`` without
``in_fq``). This file holds:

- K8's gate against JAX's ``flash_attention_qkv``, which has no gate: the
  port takes every N from 1 to 16,384 at hd a multiple of 8 up to 128 in
  bf16 and every N with an f32 plan, and refuses only the named head-dim
  residue (``K8_RESIDUE``);
- K5a's f32 gate against JAX's ``long_attention_shapes_ok`` up to the end
  of the f32 plan, and the training pair's routing unchanged;
- the ground for sharing one kernel: ``long_attention_qkv_plain`` and
  ``attention_fwd_plain`` are bit-identical in f32;
- K8's plain version against JAX in interpret mode at 577 tokens (ViT-S/16
  at 384 px), where the earlier f32 kernel raised;
- a model of the bf16 K8's two passes on the tensor cores (64-key tiles,
  exp2, the normalised p rounded to bf16) within the card's tolerance of
  the plain version and the f64 math (``long_attention.tc_errors``), and
  against JAX;
- the wrappers' launch arguments against a recording stand-in for the
  kernel library.

Inputs are numpy, seeded, and go to both packages.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qat_vit_tpu.ops.flash_attention import flash_attention_qkv as jax_flash_attention
from qat_vit_tpu.ops.long_attention import long_attention_shapes_ok as jax_long_shapes_ok
from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops import flash_attention as fa
from qat_vit_tpu_torch.ops import long_attention as la
from qat_vit_tpu_torch.ops._cuda import SMEM_LIMIT
from qat_vit_tpu_torch.ops.flash_attention import split_heads


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BF16, F32 = torch.bfloat16, torch.float32
LOG2E = np.float32(1.4426950408889634)
TILE = 64  # keys per tile of attention_q_mma.cu's passes
HDS = (1, 2, 4, 8, 12, 16, 24, 32, 40, 60, 64, 72, 96, 120, 128, 136, 192, 256)
# the head dims JAX's K8 takes and the port's kernels do not (ROADMAP Queue 3)
K8_RESIDUE = {hd for hd in HDS if hd % 8 or hd > 128}


def _qkv(b, n, h, hd, seed, dtype=F32, sd=1.5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(0, sd, (b, n, 3 * h * hd)).astype(np.float32)).to(dtype)


def test_k8_gate_matches_jax():
    """JAX's ``flash_attention_qkv`` pads N to 128 and has no gate: its
    shapes evaluate at every N and hd (traced, not run). The port's K8
    gate takes every N from 1 to 16,384 in bf16 and f32 at every hd JAX
    takes but ``K8_RESIDUE``, and refuses the residue at every N."""
    for hd in HDS:
        for dtype, jdt in ((BF16, jnp.bfloat16), (F32, jnp.float32)):
            for n in (1, 577, 16_384):
                h = 2
                spec = jax.ShapeDtypeStruct((1, n, 3 * h * hd), jdt)
                out = jax.eval_shape(lambda x: jax_flash_attention(x, h, hd), spec)
                assert out.shape == (1, n, h * hd) and out.dtype == jdt
    refused = set()
    for hd in HDS:
        for dtype in (BF16, F32):
            for n in (1, 2, 17, 127, 128, 129, 197, 421, 577, 789, 790, 1025, 2305, 4096,
                      10_001, 16_384):
                ok = fa.flash_attention_shapes_ok(n, hd, dtype)
                assert ok == (hd not in K8_RESIDUE), (n, hd, dtype)
                if not ok:
                    refused.add(hd)
    assert refused == K8_RESIDUE == {1, 2, 4, 12, 60, 136, 192, 256}
    # bf16 at any N; f32 to the end of kernel A's plan
    assert fa.flash_attention_shapes_ok(1_000_000, 128, BF16)
    assert fa.flash_attention_shapes_ok(39_080, 128, F32)
    assert not fa.flash_attention_shapes_ok(39_081, 128, F32)
    assert not fa.flash_attention_shapes_ok(0, 64, BF16)


def _old_k5a_f32_gate(n, hd):
    """The earlier f32 K5a's gate: 8 f32 score rows and q rows per block and
    two 64-key f32 tiles (rows padded by one 16-byte chunk)."""
    n4 = -(-n // 4) * 4
    tiles = 16 * 2 * 64 * (hd * 4 // 16 + 1)
    return hd % 8 == 0 and 0 < hd <= 128 and 4 * (8 * n4 + 8 * hd) + tiles <= SMEM_LIMIT


def test_k5a_f32_gate_matches_jax():
    """K5a's f32 gate is JAX's ``long_attention_shapes_ok`` at every N up to
    the end of kernel A's f32 plan (39,080 tokens at hd 128, more below);
    it takes every N the earlier kernel took (6,048 at hd 64) and more.
    The training pair routes exactly as before: JAX's cap of 4,096 and K5b's
    f32 plan still bind."""
    for hd in HDS:
        end = 39_080 if hd == 128 else 60_000
        for n in (1, 2305, 4096, 6048, 6049, 7000, 16_384, end):
            if hd <= 128 and fa.attention_f32_rows(n, hd) == 0:
                continue  # past the plan
            got = la.long_attention_shapes_ok(n, hd, F32)
            assert got == jax_long_shapes_ok(9, hd), (n, hd)
            assert got or not _old_k5a_f32_gate(n, hd)
    for hd in (8, 64, 72, 128):
        for n in (1, 197, 2305, 3601, 4096, 4097, 5024, 5025, 7000):
            old = (_old_k5a_f32_gate(n, hd) and la.long_attention_bwd_shapes_ok(n, hd, F32)
                   and -(-n // 256) * 256 <= 4096)
            assert la.long_attention_train_available(9, hd, n, F32) == old, (n, hd)
    assert la.long_attention_shapes_ok(7000, 64, F32) and not _old_k5a_f32_gate(7000, 64)
    assert not la.long_attention_shapes_ok(39_081, 128, F32)


@pytest.mark.parametrize("b,n,h,hd,n_valid", [(2, 37, 2, 8, 30), (1, 150, 2, 64, 141),
                                              (2, 20, 1, 128, 17), (1, 65, 3, 72, 65)])
def test_long_plain_is_kernel_a_plain(b, n, h, hd, n_valid):
    """K5a's f32 plain version gives kernel A's plain version's bits (q
    scaled in f32 before the index-order dot, the pinned softmax, p @ v in
    key order), with masked keys: the ground for one kernel."""
    qkv = _qkv(b, n, h, hd, n + hd, sd=1.0)
    got = la.long_attention_qkv_plain(qkv, h, hd, n_valid=n_valid)
    assert got.dtype == F32 and torch.equal(got, fa.attention_fwd_plain(qkv, h, hd,
                                                                         n_valid=n_valid))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k8_plain_matches_jax_at_577(dtype):
    """K8's plain version against JAX's kernel in interpret mode at ViT-S/16's
    577 tokens at 384 px (one head of 64), where the earlier f32 kernel
    raised: f32 rel 1e-5, bf16 within one bf16 ulp, the bounds of
    ``test_flash_attention_matches_jax``."""
    h, hd, n = 1, 64, 577
    qkv = _qkv(1, n, h, hd, 577).numpy()
    jdt, tdt = (jnp.float32, F32) if dtype == "f32" else (jnp.bfloat16, BF16)
    want = np.asarray(jax_flash_attention(jnp.asarray(qkv, jdt), h, hd, interpret=True),
                      np.float32)
    got = fa.flash_attention_qkv(torch.from_numpy(qkv).to(tdt), h, hd)
    assert got.dtype == tdt and got.shape == (1, n, h * hd)
    tol = 1e-5 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def k8_two_pass(qkv, h, hd, n_valid=None, tile=TILE):
    """The bf16 K8's algorithm (``attention_q_mma.cu`` with SCALE_AFTER): q
    unscaled in the dot, each f32 score times the f32 hd^-0.5, keys >=
    n_valid at -1e30; pass 1 the running max m and sum l of
    exp2((s - m)·log2e) over ``tile`` keys at a time; pass 2 p =
    exp2((s - m)·log2e)·(1/l) rounded to bf16, p·v summed in f32 → bf16."""
    b, n, _ = qkv.shape
    n_valid = n if n_valid is None else n_valid
    q, k, v = (t.float() for t in split_heads(qkv, h, hd))
    scale = np.float32(hd ** -0.5)

    def scores(k0, k1):
        s = (q @ k[:, :, k0:k1].transpose(-1, -2)) * scale
        return s.masked_fill(torch.arange(k0, k1) >= n_valid, -1e30)

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
    return acc.to(BF16).transpose(1, 2).reshape(b, n, h * hd)


@pytest.mark.parametrize("b,n,h,hd,n_valid", [(2, 1, 2, 64, 1), (3, 5, 2, 64, 4),
                                              (2, 197, 6, 64, 147), (1, 577, 2, 64, 577),
                                              (2, 33, 3, 8, 33), (1, 130, 2, 72, 120),
                                              (1, 200, 1, 128, 190)])
def test_k8_bf16_model_within_tolerance_of_plain(b, n, h, hd, n_valid):
    """The bf16 K8's two passes within ``tc_errors``' bound of the plain
    version: 2^-7·(1 + |plain|) element by element, and at most twice the
    plain version's rel L2 to the f64 math (which does not depend on where
    the score is scaled); N 1 to 577, masked keys, hd 8, 72, 128."""
    qkv = _qkv(b, n, h, hd, n + h + hd, BF16)
    got = k8_two_pass(qkv, h, hd, n_valid)
    plain = fa.flash_attention_qkv_plain(qkv, h, hd, n_valid=n_valid)
    ok, errs = la.tc_errors(got, plain, la.long_attention_f64(qkv, h, hd, n_valid=n_valid)[0], 1)
    assert ok, errs


def test_k8_bf16_model_matches_jax():
    """The bf16 K8's two passes against JAX's K8 in interpret mode at ViT-S
    widths (6 heads of 64, 197 tokens): within one bf16 ulp."""
    h, hd, n = 6, 64, 197
    qkv = _qkv(1, n, h, hd, 11, sd=1.0).numpy()
    want = np.asarray(jax_flash_attention(jnp.asarray(qkv, jnp.bfloat16), h, hd,
                                          interpret=True), np.float32)
    got = k8_two_pass(torch.from_numpy(qkv).to(BF16), h, hd).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


class _Recorder:
    """A stand-in kernel library: records each entry point's arguments."""

    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        assert len(args) == len(_build._SIGNATURES[name]), (name, len(args))
        self.calls.append((name, args))


def test_launch_arguments(monkeypatch):
    """What the wrappers hand the kernels (CPU tensors, a recording
    library): K8 in bf16 to ``qvt_flash_attention_mma``, in f32 to
    ``qvt_flash_attention_f32``, each with the f32 hd^-0.5 for the score
    and ``n_valid``, at 577 and 7,000 tokens; K5a in f32 to kernel A's
    ``qvt_attention_fwd`` with no fake-quant pointer, ``in_fq`` 0 and the
    f32 q scale; an f32 qkv not 16-byte aligned, hd 60 and float16 raise
    before any launch; one count per call."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "load", lambda: rec)
    for mod in (fa, la):
        monkeypatch.setattr(mod, "use_plain", lambda t: False)
        monkeypatch.setattr(mod, "stream_of", lambda dev: 0)
    scale = float(np.float32(64 ** -0.5))
    f0, l0 = fa.flash_attention_qkv.launches, la.long_attention_qkv.launches
    for n in (577, 7000):
        for dtype, entry in ((BF16, "qvt_flash_attention_mma"), (F32, "qvt_flash_attention_f32")):
            qkv = torch.zeros(2, n, 3 * 3 * 64, dtype=dtype)
            out = fa.flash_attention_qkv(qkv, 3, 64, n_valid=n - 5)
            name, args = rec.calls[-1]
            assert name == entry and out.dtype == dtype and out.shape == (2, n, 3 * 64)
            assert args[:2] == (qkv.data_ptr(), out.data_ptr())
            assert args[2:8] == (2, n, 3, 64, n - 5, scale)
        qkv = torch.zeros(1, n, 3 * 2 * 64)
        out = la.long_attention_qkv(qkv, 2, 64)
        name, args = rec.calls[-1]
        assert name == "qvt_attention_fwd"
        assert args[:3] == (qkv.data_ptr(), None, out.data_ptr())
        assert args[3:12] == (1, n, 2, 64, n, scale, 0, 0.0, 0.0)
    assert fa.flash_attention_qkv.launches == f0 + 4
    assert la.long_attention_qkv.launches == l0 + 2
    calls = len(rec.calls)
    skew = torch.zeros(2 * 17 * 192 + 1)[1:].view(2, 17, 192)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_qkv(skew, 1, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        la.long_attention_qkv(skew, 1, 64)
    with pytest.raises(ValueError, match="unsupported"):
        fa.flash_attention_qkv(torch.zeros(1, 17, 180, dtype=BF16), 1, 60)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_qkv(torch.zeros(1, 17, 192, dtype=torch.float16), 1, 64)
    assert len(rec.calls) == calls and fa.flash_attention_qkv.launches == f0 + 4
