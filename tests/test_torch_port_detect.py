"""Port parity for int8 OWLv2 detection serving, at micro size (pruned
geometry cut to image 32, patch 8, D 64, 2 heads, hd 32, depth 2, MLP 128:
17 tokens; pre-encoder LN, quick-GELU, bias-free patches, LN eps 1e-5).

JAX params, observer stats and exports are carried across by
``qat_vit_tpu_torch.models.jax_params`` (numpy only); inputs are numpy,
seeded, and go to both packages. The JAX package's Pallas kernels run in
interpret mode, the long-sequence chain as ONE jitted call (see
``tests/test_fused_serve.py::interpret_apply``).
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

from qat_vit_tpu.models import owlv2 as jax_owlv2
from qat_vit_tpu.models.owlv2_detect import create_detector as jax_create_detector
from qat_vit_tpu.models.owlv2_detect import detector_config as jax_detector_config
from qat_vit_tpu.models.vit import VisionTransformer as JaxVisionTransformer
from qat_vit_tpu.models.vit import count_fake_quant_sites as jax_count_sites
from qat_vit_tpu.ops.long_attention import long_attention_qkv as jax_long_attention
from qat_vit_tpu.ops.quantized_matmul import quantize_act_shifted as jax_quantize
from qat_vit_tpu.quant.convert import act_output_qparams as jax_act_output_qparams
from qat_vit_tpu.quant.qconfig import default_qat_qconfig as jax_qconfig
from qat_vit_tpu.serve.int8_detect import convert_detector as jax_convert_detector
from qat_vit_tpu.serve.int8_detect import int8_detect_apply as jax_int8_detect_apply
from qat_vit_tpu.serve.int8_vit import _preset_kernel_opts as jax_preset_kernel_opts
from qat_vit_tpu.serve.int8_vit import int8_apply as jax_int8_apply
from qat_vit_tpu_torch.models import jax_params, owlv2
from qat_vit_tpu_torch.models.owlv2_detect import create_detector, detector_config
from qat_vit_tpu_torch.models.registry import (
    create_model,
    create_student,
    create_teacher,
    list_available_models,
)
from qat_vit_tpu_torch.models.vit import ViTConfig, count_fake_quant_sites
from qat_vit_tpu_torch.ops.long_attention import (
    long_attention_q,
    long_attention_qkv,
    long_attention_shapes_ok,
)
from qat_vit_tpu_torch.ops.long_block_kernel import (
    LONG_PLAIN_OPS,
    long_block_forward,
    long_model_forward,
)
from qat_vit_tpu_torch.quant.convert import (
    act_output_qparams,
    xla_erf_f32,
    xla_exp_f32,
    xla_logistic_f32,
)
from qat_vit_tpu_torch.quant.qconfig import default_qat_qconfig
from qat_vit_tpu_torch.serve.calibrate import calibrate_detector
from qat_vit_tpu_torch.serve.int8_detect import (
    convert_detector,
    int8_detect_apply,
    make_int8_detect_forward,
)
from qat_vit_tpu_torch.serve.int8_vit import _preset_kernel_opts, int8_apply, serving_preset


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MICRO = dict(image_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2, mlp_ratio=2.0)
OUTPUTS = ("pred_boxes", "logits", "objectness_logits", "class_embeds", "image_embeds")


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        if hasattr(v, "items"):
            out.update(_leaves(v, name))
        elif v is not None:
            out[name] = np.asarray(v)
    return out


def _int8_close(got, want, min_exact=0.999):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= min_exact, (diff == 0).mean()


def _jax_interpret(fn, *args):
    """One jitted call under the Mosaic-TPU interpreter (eager glue beside
    interpreted kernels deadlocks: tests/test_fused_serve.py)."""
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
    return out


# ---------------------------------------------------------------------------
# the quick-GELU export against JAX
# ---------------------------------------------------------------------------

def test_xla_erf_f32_is_jax_erf():
    """The port's emulation of XLA's f32 erf (clamp, x·P(x²)/Q(x²) by FMA
    Horner steps) against ``jax.scipy.special.erf`` on the CPU: identical
    bits on 2·10^5 seeded f32 inputs, the tails past the clamp included;
    torch.erf differs from it on about half of them."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(0, 3, 150_000), rng.uniform(-6, 6, 50_000)]).astype(np.float32)
    want = np.asarray(jax.scipy.special.erf(jnp.asarray(x)))
    got = xla_erf_f32(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (torch.erf(torch.from_numpy(x)).numpy() != want).mean() > 0.1


def _exp_sweep():
    """10^6 seeded N(0, 3) f32 inputs, a dense sweep over [-110, 95] and the
    ends: ±inf, nan, the last finite results at either end."""
    rng = np.random.default_rng(11)
    ends = [np.inf, -np.inf, np.nan, 88.72283, 88.7229, -87.3365, -87.34, -88.722, -104.0, 89.0,
            0.0, -0.0]
    return np.concatenate([rng.normal(0, 3, 1_000_000), np.linspace(-110, 95, 200_001),
                           ends]).astype(np.float32)


def _same_bits(got, want):
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.int32), want[ok].view(np.int32))


def test_xla_exp_f32_and_logistic_are_jax():
    """The port's emulation of XLA's f32 exp (Cephes: m = min(floor(x·log2e
    + 1/2), 127), a two-step FMA reduction, a degree-5 polynomial by FMA
    Horner steps, 2^m, subnormal results flushed) and the logistic built on
    it, ``1 / (1 + exp(-x))`` flushed likewise, against ``jax.numpy.exp``
    and ``jax.nn.sigmoid`` on the CPU: identical bits over the sweep,
    overflow, underflow and nan included; torch.exp and torch.sigmoid
    differ from them on thousands of these inputs."""
    x = _exp_sweep()
    want_exp = np.asarray(jnp.exp(jnp.asarray(x)))
    want_sig = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    _same_bits(xla_exp_f32(torch.from_numpy(x)).numpy(), want_exp)
    _same_bits(xla_logistic_f32(torch.from_numpy(x)).numpy(), want_sig)
    assert (torch.exp(torch.from_numpy(x)).numpy() != want_exp).sum() > 10_000
    assert (torch.sigmoid(torch.from_numpy(x)).numpy() != want_sig).sum() > 1_000


def test_act_output_qparams_match_jax():
    """600 seeded observer ranges through both packages' convert-time
    activation qparams: identical scale, zero point and quant_max for GELU
    (the port computes XLA's erf, ``xla_erf_f32``, and JAX's eager ``v /
    f32(√2)``) and for quick-GELU (its scan of ``v·sigmoid(1.702 v)`` takes
    XLA's logistic, ``xla_logistic_f32``)."""
    rng = np.random.default_rng(0)
    jc, tc = jax_qconfig(), default_qat_qconfig()
    for _ in range(600):
        lo, hi = np.float32(-abs(rng.normal(0, 4))), np.float32(abs(rng.normal(0, 6)))
        for act in ("gelu", "quick_gelu"):
            j = jax_act_output_qparams(jnp.float32(lo), jnp.float32(hi), jc, act=act)
            t = act_output_qparams(torch.tensor(lo), torch.tensor(hi), tc, act=act)
            for k in ("scale", "zero_point", "quant_max"):
                assert np.float32(t[k].item()) == np.float32(j[k]), (act, lo, hi, k)


# ---------------------------------------------------------------------------
# geometry and registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ratios", [(0.75, 0.75, 0.75), (0.5, 0.5, 0.5), (0.25, 1.0, 0.4)])
def test_owlv2_geometry_matches_jax(ratios):
    assert owlv2.OWLV2_BASE_VISION == jax_owlv2.OWLV2_BASE_VISION
    assert owlv2.OWLV2_BASE_TEXT == jax_owlv2.OWLV2_BASE_TEXT
    assert (owlv2.prune_owlv2_geometry(owlv2.OWLV2_BASE_VISION, *ratios)
            == jax_owlv2.prune_owlv2_geometry(jax_owlv2.OWLV2_BASE_VISION, *ratios))
    for pruned in (False, True):
        assert (owlv2.owlv2_vision_vit_kwargs(pruned, *ratios)
                == jax_owlv2.owlv2_vision_vit_kwargs(pruned, *ratios))


def test_registry_detection_entries():
    info = list_available_models()
    assert info["owlv2_pruned_detector"]["task"] == "detection"
    assert info["owlv2_base_detector"]["task"] == "detection"
    assert info["owlv2_student_pruned"]["task"] == "classification"
    cfg = detector_config(pruned=True)
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.head_dim, cfg.mlp_dim, cfg.seq_len,
            cfg.num_classes, cfg.pre_norm, cfg.act, cfg.patch_bias, cfg.layer_norm_eps) == (
        576, 9, 9, 64, 3072, 2305, 0, True, "quick_gelu", False, 1e-5)
    b = create_model("owlv2_pruned_detector", qat_wrapper=True, **MICRO)
    assert b.task == "detection" and b.cfg.num_classes == 0 and b.cfg.quant is not None
    out = b.module(torch.zeros(1, 32, 32, 3))
    assert out["pred_boxes"].shape == (1, 16, 4) and "logits" not in out
    s = create_student("owlv2", **MICRO)
    assert s.cfg.pre_norm and s.cfg.num_classes == 10 and s.module(torch.zeros(1, 32, 32, 3)).shape == (1, 10)
    t = create_teacher("owlv2", image_size=32, patch_size=8, depth=1)
    assert (t.cfg.embed_dim, t.cfg.num_heads, t.cfg.qat_wrapper, t.cfg.quant) == (768, 12, False, None)


# ---------------------------------------------------------------------------
# the micro detector in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def micro():
    """JAX micro detector (params + stats after 2 observed forwards) and its
    port twin loaded with the same params, observed on the same batches."""
    jdet, jcfg = jax_create_detector(pruned=True, qat_wrapper=True, **MICRO)
    rng = np.random.default_rng(0)
    batches = [rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32) for _ in range(3)]
    v = nn.meta.unbox(jdet.init(jax.random.key(0), jnp.asarray(batches[0]), observe=False))
    params = jax.device_get(v["params"])
    qs = v["quant_stats"]
    for x in batches[:2]:
        _, mut = jdet.apply({"params": params, "quant_stats": qs}, jnp.asarray(x), observe=True,
                            mutable=["quant_stats"])
        qs = mut["quant_stats"]
    tdet, tcfg = create_detector(pruned=True, qat_wrapper=True, **MICRO)
    jax_params.load_jax_variables(tdet, params)
    with torch.no_grad():
        for x in batches[:2]:
            tdet(torch.from_numpy(x), observe=True)
    return jdet, jcfg, params, jax.device_get(qs), tdet, tcfg, batches


def test_fake_quant_site_count(micro):
    """Pre-norm feature-mode tower: 9 weight + 16 activation sites at depth 2
    (no head; the pre-encoder LN output and the input stub), as JAX counts."""
    _, jcfg, _, _, tdet, tcfg, _ = micro
    want = count_fake_quant_sites(tcfg)
    assert want == jax_count_sites(jcfg) == {"weight": 9, "activation": 16}
    sites = [n for n in tdet.state_dict() if n.endswith(".min_val")]
    assert len(sites) == 25 and sum(".weight_fq." in s for s in sites) == 9


def test_tower_tokens_and_observers_match_jax(micro):
    """Feature-mode tower on the same params and inputs. f32 (no fake-quant):
    summation order only, tokens to 1e-5. Observer stats after 2 observed
    forwards: rel 1e-5 (the calibration bound of tests/test_torch_port_model.py).
    Fake-quant tokens: f32 noise could move one element across a rounding
    tie (a grid step there); on these inputs none does, measured max |diff|
    2.4e-7, bound 1e-5."""
    jdet, jcfg, params, qs, tdet, tcfg, batches = micro
    x = batches[2]
    fcfg = dataclasses.replace(jcfg, quant=None)
    want = np.asarray(JaxVisionTransformer(fcfg).apply({"params": params["vision"]},
                                                       jnp.asarray(x)))
    ftower = create_detector(pruned=True, **MICRO)[0].vision
    jax_params.load_jax_variables(ftower, params["vision"])
    with torch.no_grad():
        got = ftower(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 17, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    j = _leaves(qs)
    t = _leaves(jax_params.buffers_to_quant_stats(dict(tdet.state_dict())))
    assert j.keys() == t.keys() and len(j) == 2 * 25
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-7, err_msg=k)

    want = np.asarray(JaxVisionTransformer(jcfg).apply(
        {"params": params["vision"], "quant_stats": qs["vision"]}, jnp.asarray(x)))
    with torch.no_grad():
        got = tdet.vision(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("queries", ["none", "all", "masked"])
def test_detector_matches_jax(micro, queries):
    """The float detector (f32 tower + heads) on the same params: all five
    outputs to 1e-4 (f32 summation order through two blocks and three MLP
    layers); masked query logits are finfo.min in both."""
    jdet, jcfg, params, _, _, _, batches = micro
    fdet_j = jax_create_detector(pruned=True, **MICRO)[0]
    fdet_t = create_detector(pruned=True, **MICRO)[0]
    jax_params.load_jax_variables(fdet_t, params)
    rng = np.random.default_rng(1)
    x = batches[2]
    q = rng.normal(0, 1, (4, 3, 512)).astype(np.float32) if queries != "none" else None
    mask = None
    if queries == "masked":
        mask = np.ones((4, 3), np.int32)
        mask[1, 2:] = 0
        mask[3, 0] = 0
    want = fdet_j.apply({"params": params}, jnp.asarray(x),
                        None if q is None else jnp.asarray(q),
                        None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = fdet_t(torch.from_numpy(x), None if q is None else torch.from_numpy(q),
                     None if mask is None else torch.from_numpy(mask))
    assert set(got) == set(want) == (set(OUTPUTS) if q is not None else set(OUTPUTS) - {"logits"})
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    if mask is not None:
        masked = np.broadcast_to(mask[:, None, :] == 0, got["logits"].shape)
        assert (got["logits"].numpy()[masked] == np.finfo(np.float32).min).all()


def test_convert_detector_matches_jax(micro):
    """convert_detector on both packages from the same params and stats: the
    int8 tower export (no head, norm_pre kept) is byte-identical, and so is
    the same tower converted as a GELU model (the quick-GELU gelu_q
    qparams included, see test_act_output_qparams_match_jax); the float
    head params are the same tensors."""
    _, jcfg, params, qs, _, tcfg, _ = micro
    sd = jax_params.params_to_state_dict(params)
    for act in ("quick_gelu", "gelu"):
        jexp = jax.device_get(jax_convert_detector(params, qs,
                                                   dataclasses.replace(jcfg, act=act)))
        texp = convert_detector(sd, jax_params.quant_stats_to_buffers(qs),
                                dataclasses.replace(tcfg, act=act))
        assert "head" not in texp["tower"] and "norm_pre" in texp["tower"]
        j, t = _leaves(jexp["tower"]), _leaves(texp["tower"])
        assert j.keys() == t.keys()
        for k in j:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=(act, k))
    heads = jax_params.params_to_state_dict(jexp["heads"])
    assert heads.keys() == texp["heads"].keys()
    for k in heads:
        assert torch.equal(heads[k], texp["heads"][k]), k
    # calibrate_detector observes the tower only, under the detector's names
    stats = calibrate_detector(sd, [torch.zeros(2, 32, 32, 3)], tcfg)
    assert len(stats) == 2 * 25 and all(k.startswith("vision.") for k in stats)


@pytest.fixture(scope="module")
def export(micro):
    """The JAX detector export, as numpy and as the port's tree."""
    _, jcfg, params, qs, _, tcfg, _ = micro
    jexp = jax.device_get(jax_convert_detector(params, qs, jcfg))
    return jcfg, tcfg, jexp, jax_params.detector_export_from_numpy(jexp)


def test_int8_detect_exact_matches_jax(export):
    """The exact path (f32 stream, exact integer GEMMs, quick-GELU) on the
    same export, with 4 queries: f32 summation order only, through two int8
    blocks and the float heads (no int8 element flips on these inputs):
    measured max |diff| 1.4e-6, bound 1e-4."""
    jcfg, tcfg, jexp, texp = export
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    q = rng.normal(0, 1, (4, 4, 512)).astype(np.float32)
    want = jax_int8_detect_apply(jax.tree.map(jnp.asarray, jexp), jnp.asarray(x), jcfg,
                                 jnp.asarray(q))
    got = int8_detect_apply(texp, torch.from_numpy(x), tcfg, torch.from_numpy(q))
    for k in OUTPUTS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    fwd = make_int8_detect_forward(tcfg, "cpu")
    assert fwd.options == {}
    for k, v in fwd(texp, torch.from_numpy(x), torch.from_numpy(q)).items():
        assert torch.equal(v, got[k]), k


# ---------------------------------------------------------------------------
# the long-sequence kernels' plain versions and the K6 chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [129, 300])
def test_long_attention_matches_jax(n):
    """K5a's plain version against JAX ``long_attention_qkv`` (interpret,
    q_tile 128: 129 and 300 tokens are padded to 256 and 384 there), H 3,
    hd 32. bf16: the same roundings up to the softmax's f32 (JAX) vs f64
    (port) arithmetic, so within one bf16 step (rel 2^-8; measured: 0.03%
    of elements differ at 300 tokens, none at 129). int8 (the K6 form, on
    an f32 qkv so that JAX's output is the f32 o): within ±1, at least 99.9%
    exact (measured 99.998%)."""
    rng = np.random.default_rng(n)
    heads, hd = 3, 32
    qkv = rng.normal(0, 1, (2, n, 3 * heads * hd)).astype(np.float32)
    want = np.asarray(jax_long_attention(jnp.asarray(qkv, jnp.bfloat16), heads, hd, q_tile=128,
                                         interpret=True), np.float32)
    got = long_attention_qkv(torch.from_numpy(qkv).to(torch.bfloat16), heads, hd)
    assert got.dtype == torch.bfloat16 and got.shape == (2, n, heads * hd)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=2 ** -8)

    out_q = {"scale": torch.tensor(np.float32(1.5 / 255)), "zero_point": torch.tensor(120.0)}
    want = jax_quantize(jax_long_attention(jnp.asarray(qkv), heads, hd, q_tile=128,
                                           interpret=True),
                        np.float32(1.5 / 255), np.float32(120.0))
    got = long_attention_qkv(torch.from_numpy(qkv), heads, hd, out_q=out_q)
    assert got.dtype == torch.int8
    assert torch.equal(got, long_attention_q(torch.from_numpy(qkv), heads, hd, out_q=out_q))
    _int8_close(got.numpy(), np.asarray(want))


def test_long_attention_masks_keys():
    """Keys >= n_valid add exact zeros: the valid rows of a sequence with
    padding equal those of the unpadded sequence, bit for bit."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(0, 1, (1, 40, 3 * 64)).astype(np.float32)).to(torch.bfloat16)
    padded = torch.cat([qkv, torch.from_numpy(rng.normal(0, 1, (1, 9, 3 * 64)).astype(np.float32))
                        .to(torch.bfloat16)], dim=1)
    assert torch.equal(long_attention_qkv(padded, 2, 32, n_valid=40)[:, :40],
                       long_attention_qkv(qkv, 2, 32))


def test_long_chain_matches_jax(export):
    """The K6 chain through the plain versions (``megamodel_long`` on the
    CPU) against JAX's ``megamodel_long:64:32`` in interpret mode (17 tokens
    padded to 128 there), both bf16 stream + in-kernel quick-GELU, feature
    mode: the dequantized tokens. LN/softmax sums differ in order and the
    entry LN quantizes by multiplication here, by division in JAX, and the
    pre-encoder LN's f32 vs f64 statistics round to bf16 apart now and then:
    int8 elements flip by one, each a grid step of the final LN (0.027).
    Measured: 5.1% of the tokens one step apart, mean |diff| 1.4e-3; bound
    mean 3e-3, max one step. In the port
    megablock_long (K6a chained) equals megamodel_long (K6b) bit for bit,
    and the *_plain twin is the same chain."""
    jcfg, tcfg, jexp, texp = export
    x = np.random.default_rng(3).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(_jax_interpret(
        partial(jax_int8_apply, cfg=jcfg, compute_dtype=jnp.bfloat16,
                fused="megamodel_long:64:32"),
        jax.tree.map(jnp.asarray, jexp["tower"]), jnp.asarray(x)))
    kw = dict(compute_dtype=torch.bfloat16)
    got = int8_apply(texp["tower"], torch.from_numpy(x), tcfg, fused="megamodel_long", **kw)
    assert got.shape == want.shape == (2, 17, 64)
    step = float(texp["tower"]["norm"]["out_q"]["scale"])
    diff = np.abs(got.numpy() - want)
    assert diff.mean() <= 3e-3 and diff.max() <= step * 1.001, (diff.mean(), diff.max(), step)
    for mode in ("megablock_long", "megamodel_long_plain:512:256:su5:cu2:bb2",
                 "megablock_long_plain:64"):
        assert torch.equal(int8_apply(texp["tower"], torch.from_numpy(x), tcfg, fused=mode, **kw),
                           got), mode
    # the exact path with K5a's attention (bf16) stays close to the exact
    # path (f32 attention): measured mean |diff| 5.0e-5
    exact = int8_apply(texp["tower"], torch.from_numpy(x), tcfg)
    k5a = int8_apply(texp["tower"], torch.from_numpy(x), tcfg, attn_impl="pallas_long",
                     attn_dtype=torch.bfloat16)
    assert (k5a - exact).abs().mean() <= 1e-3


def test_long_block_and_model_forward_identical(export):
    """long_model_forward is long_block_forward looped: identical outputs."""
    _, tcfg, _, texp = export
    tower = texp["tower"]
    rng = np.random.default_rng(4)
    zq = torch.from_numpy(rng.integers(-128, 128, (2, 17, 64), dtype=np.int8))
    x = torch.from_numpy(rng.normal(0, 1, (2, 17, 64)).astype(np.float32)).to(torch.bfloat16)
    kw = dict(num_heads=2, head_dim=32, act="quick_gelu", eps=1e-5, n_valid=17,
              ops=LONG_PLAIN_OPS)
    x1, z1 = long_model_forward(zq, x, tower["blocks"], tower["norm"], depth=2, **kw)
    x2, z2 = long_block_forward(zq, x, tower["blocks"]["0"], tower["blocks"]["1"]["norm1"], **kw)
    x2, z2 = long_block_forward(z2, x2, tower["blocks"]["1"], tower["norm"], **kw)
    assert torch.equal(x1, x2) and torch.equal(z1, z2)
    assert x1.dtype == torch.bfloat16 and z1.dtype == torch.int8


def test_detection_preset_gates():
    """CPU: the exact defaults. CUDA: megamodel_long for OWLv2-pruned (2,305
    tokens) and OWLv2-base (960 px, 3,601 tokens), megamodel for ViT-S,
    mixed_none + K3 for short quick-GELU models whose widths JAX's slab
    kernels take, JAX's rung 4 (mixed_none + the long attention) for
    OWLv2-pruned's 576 at 224 px, which they do not; at 1,600 px (10,001
    tokens) JAX's rung, which is mixed_none + its long attention there
    (its whole-model kernel's working set does not fit): the streaming
    kernels take any N, so nothing raises; the ``i8`` flag runs the
    int8-score chain."""
    pruned, base = detector_config(pruned=True), detector_config(pruned=False)
    assert serving_preset(pruned, "cpu") == {}
    assert _preset_kernel_opts(pruned) == {"fused": "megamodel_long"}
    assert _preset_kernel_opts(base) == {"fused": "megamodel_long"}
    assert base.seq_len == 3601 and long_attention_shapes_ok(3601, 64)
    assert _preset_kernel_opts(ViTConfig()) == {"fused": "megamodel"}
    assert serving_preset(pruned, "cuda")["fused"] == "megamodel_long"
    assert _preset_kernel_opts(ViTConfig(act="quick_gelu")) == {
        "fused": "mixed_none", "attn_impl": "pallas_fused"}  # 197 quick-GELU tokens
    assert _preset_kernel_opts(dataclasses.replace(pruned, image_size=224)) == {
        "fused": "mixed_none", "attn_impl": "pallas_long"} == jax_preset_kernel_opts(
        jax_detector_config(pruned=True, image_size=224))  # width 576: no slab kernel
    huge = dataclasses.replace(pruned, image_size=1600)  # 10,001 tokens
    long_k5a = {"fused": "mixed_none", "attn_impl": "pallas_long"}
    assert jax_preset_kernel_opts(jax_detector_config(pruned=True, image_size=1600)) == long_k5a
    assert _preset_kernel_opts(huge) == long_k5a
    x = torch.zeros(1, 32, 32, 3)
    tower = convert_detector(*_tiny_export_inputs(), dataclasses.replace(
        detector_config(pruned=True, **MICRO), quant=default_qat_qconfig()))["tower"]
    i8 = int8_apply(tower, x, detector_config(pruned=True, **MICRO),
                    fused="megamodel_long:512:256:i8")
    assert i8.shape == (1, 17, 64) and torch.isfinite(i8).all()
    with pytest.raises(NotImplementedError, match="mixed_none"):  # K4's chain is GELU-only
        int8_apply(tower, x, detector_config(pruned=True, **MICRO), fused="megamodel")
    for bad in ("megamodel_long:x", "megamodel_long:512:256:zz1", "megamodel:x"):
        with pytest.raises(ValueError):
            int8_apply(tower, x, detector_config(pruned=True, **MICRO), fused=bad)


def _tiny_export_inputs():
    """A calibrated micro detector's state_dict and observer buffers."""
    det, cfg = create_detector(pruned=True, qat_wrapper=True,
                               generator=torch.Generator().manual_seed(0), **MICRO)
    with torch.no_grad():
        det(torch.from_numpy(np.random.default_rng(6).normal(0, 1, (2, 32, 32, 3))
                             .astype(np.float32)), observe=True)
    sd = det.state_dict()
    return ({k: v for k, v in sd.items() if not k.endswith(("min_val", "max_val"))},
            {k: v for k, v in sd.items() if k.endswith(("min_val", "max_val"))})
