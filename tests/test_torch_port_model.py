"""Port parity: the ViT model, PTQ calibration and the int8 export of
``qat_vit_tpu_torch`` against ``qat_vit_tpu`` at micro size
(``vit_micro_test``: D 128, depth 2, 2 heads, hd 64, 32 px, 17 tokens).

JAX params and observer stats are carried across by
``qat_vit_tpu_torch.models.jax_params`` (numpy only); inputs are numpy,
seeded, and go to both packages.
"""

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from qat_vit_tpu.models.registry import create_model as jax_create_model
from qat_vit_tpu.serve.calibrate import calibrate as jax_calibrate
from qat_vit_tpu.serve.int8_vit import convert_vit as jax_convert_vit
from qat_vit_tpu_torch.models import jax_params
from qat_vit_tpu_torch.models.registry import create_model, create_student, list_available_models
from qat_vit_tpu_torch.models.vit import count_fake_quant_sites
from qat_vit_tpu_torch.serve.calibrate import calibrate
from qat_vit_tpu_torch.serve.int8_vit import convert_vit


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        if hasattr(v, "items"):
            out.update(_leaves(v, name))
        elif v is not None:
            out[name] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def micro():
    """JAX micro model (params + observed stats) and its port twin."""
    jm = jax_create_model("vit_micro_test", qat_wrapper=True)
    v = nn.meta.unbox(jm.module.init(jax.random.key(0), jm.example_input(1), observe=False))
    params = jax.device_get(v["params"])
    rng = np.random.default_rng(0)
    batches = [rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32) for _ in range(3)]
    tm = create_model("vit_micro_test", qat_wrapper=True)
    jax_params.load_jax_variables(tm.module, params)
    return jm, params, batches, tm


def test_registry_geometry():
    info = list_available_models()
    assert {"vit_small_patch16_224_student", "vit_base_patch16_224_teacher",
            "vit_tiny_patch16_224", "vit_micro_test"} <= set(info)
    s = create_student("vit", generator=torch.Generator().manual_seed(0))
    cfg = s.cfg
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.head_dim, cfg.mlp_dim,
            cfg.seq_len, cfg.num_classes) == (384, 12, 6, 64, 1536, 197, 10)
    s2 = create_student("vit", generator=torch.Generator().manual_seed(0))
    for a, b in zip(s.module.parameters(), s2.module.parameters()):
        assert torch.equal(a, b)  # a seed gives the same weights


def test_fake_quant_site_count(micro):
    """26 sites on a 2-block model (10 weight + 16 activation), as torch prepare_qat."""
    _, _, _, tm = micro
    sites = [n for n in tm.module.state_dict() if n.endswith(".min_val") or n == "input_fq.min_val"]
    want = count_fake_quant_sites(tm.cfg)
    assert want == {"weight": 10, "activation": 16}
    assert len(sites) == 26
    assert sum(".weight_fq." in s for s in sites) == 10


def test_float_forward_matches_jax(micro):
    """Float model (no fake-quant): f32 math in a different summation order,
    so logits agree to f32 accumulation noise (atol 1e-5 on O(1) logits)."""
    jm, params, batches, _ = micro
    jf = jax_create_model("vit_micro_test")
    jl = jf.module.apply({"params": params}, jnp.asarray(batches[0]), observe=False)
    tf = create_model("vit_micro_test")
    jax_params.load_jax_variables(tf.module, params)
    with torch.no_grad():
        tl = tf.module(torch.from_numpy(batches[0]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)


def _calibrated_pair(micro, n_batches):
    jm, params, batches, tm = micro
    batches = batches[:n_batches]
    jqs = jax.device_get(jax_calibrate(params, [jnp.asarray(b) for b in batches], jm.cfg))
    tqs = calibrate(jax_params.params_to_state_dict(params),
                    [torch.from_numpy(b) for b in batches], tm.cfg)
    j, t = _leaves(jqs), _leaves(jax_params.buffers_to_quant_stats(tqs))
    assert j.keys() == t.keys() and len(j) == 2 * 26
    return j, t


def test_calibration_matches_jax(micro):
    """JAX calibrate vs port calibrate on the same params and batches (the
    first-call init, then one EMA step): observer min/max agree to rel 1e-5.
    Only the f32 summation order of GEMMs/LN/softmax differs, and for these
    seeded inputs no fake-quant rounding lands on the other side of a tie."""
    j, t = _calibrated_pair(micro, 2)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_calibration_flip_bound(micro):
    """Over a longer calibration a summation-order difference can move one
    fake-quantized element across a rounding tie: one grid step in one
    element, which the EMA (c = 0.01) passes on as at most 0.01 of the
    downstream site's grid step. Each stat stays within that of JAX's."""
    j, t = _calibrated_pair(micro, 3)
    for k in j:
        site = k.rsplit("/", 1)[0]
        step = (j[f"{site}/max_val"] - j[f"{site}/min_val"]) / 255.0
        assert abs(t[k] - j[k]) <= 1e-5 * abs(j[k]) + 0.01 * step, k


def test_quant_stats_round_trip(micro):
    jm, params, batches, tm = micro
    jqs = jax.device_get(jax_calibrate(params, [jnp.asarray(batches[0])], jm.cfg))
    bufs = jax_params.quant_stats_to_buffers(jqs)
    back = jax_params.buffers_to_quant_stats(bufs)
    a, b = _leaves(jqs), _leaves(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k


@pytest.mark.parametrize("per_channel", [False, True])
def test_export_matches_jax(micro, per_channel):
    """convert_vit on both packages from the same params and stats:
    w_int8 / w_colsum identical, every scale / zero-point / float to rel 1e-6."""
    jm, params, batches, tm = micro
    jqs = jax.device_get(jax_calibrate(params, [jnp.asarray(b) for b in batches], jm.cfg))
    jexp = jax.device_get(jax_convert_vit(params, jqs, jm.cfg,
                                          per_channel_weights=per_channel))
    texp = convert_vit(jax_params.params_to_state_dict(params),
                       jax_params.quant_stats_to_buffers(jqs), tm.cfg,
                       per_channel_weights=per_channel)
    j, t = _leaves(jexp), _leaves(texp)
    assert j.keys() == t.keys()
    for k in j:
        assert t[k].shape == j[k].shape, k
        if k.endswith(("w_int8", "w_colsum")):
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        else:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-6, atol=0, err_msg=k)
