"""Port parity for OWLv2 detection KD + QAT training, at micro size, on the CPU.

- the long-sequence training attention (``long_attention_train``: K5a and
  K5b through their plain versions) against the JAX pair in interpret mode,
  forward and dqkv, f32 and bf16; padding; the gate against JAX's cap;
- ``detection_kd_loss`` and the detection train step (float and QAT, cached
  teacher, f32, both packages on their long-sequence branch) against JAX;
- ``DetectKDTrainer``: the phase switch, the teacher-output cache, padded
  eval, convert against JAX's ``convert_detector``, int8 eval;
- ``KDQATTrainer`` with ``student_family="owlv2"``.

Inputs are numpy, seeded, and go to both packages. The JAX attention kernels
run in interpret mode (``QVT_ATTN_INTERPRET=1``).
"""

import functools

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from qat_vit_tpu.models.owlv2_detect import create_detector as jax_create_detector
from qat_vit_tpu.ops.long_attention import long_attention_train as jax_long_attention_train
from qat_vit_tpu.ops.long_attention import (
    long_attention_train_available as jax_long_attention_train_available,
)
from qat_vit_tpu.serve.int8_detect import convert_detector as jax_convert_detector
from qat_vit_tpu.train import detect_steps as jax_detect_steps
from qat_vit_tpu.train import steps as jax_steps
from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
from qat_vit_tpu_torch.models import jax_params
from qat_vit_tpu_torch.models import vit as port_vit
from qat_vit_tpu_torch.models.owlv2_detect import create_detector
from qat_vit_tpu_torch.ops import long_attention as la
from qat_vit_tpu_torch.train import detect_steps, steps
from qat_vit_tpu_torch.train.config import load_hparams
from qat_vit_tpu_torch.train.detect_trainer import DetectKDTrainer
from tests.test_torch_port_train import _leaves, _sync_to_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# 3 heads of 16: the packed width 48 is not 128-lane aligned, so JAX's slab
# kernels refuse it and both packages take their long-sequence branch
GEO = dict(image_size=32, patch_size=8, embed_dim=48, depth=2, num_heads=3, mlp_ratio=2.0)
TEXT_DIM, QUERIES = 64, 3


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("QVT_ATTN_INTERPRET", "1")


# ---------------------------------------------------------------------------
# the training pair: K5a + K5b (plain) vs the JAX Pallas pair (interpret)
# ---------------------------------------------------------------------------

def _long_pair(dtype, b=2, n=300, heads=3, hd=32):
    """(port out, port dqkv, JAX out, JAX dqkv): ``do`` is the cotangent."""
    rng = np.random.default_rng(n)
    qkv = rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32)
    do = rng.normal(0, 1, (b, n, heads * hd)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)

    def jfn(q):
        return jax_long_attention_train(q, heads, hd, 128, True)

    jq = jnp.asarray(qkv).astype(jdt)
    jout, jgrad = jax.jit(lambda q: (jfn(q), jax.grad(
        lambda v: (jfn(v).astype(jnp.float32) * do).sum())(q)))(jq)
    x = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    out = la.long_attention_train(x, heads, hd)
    (out.float() * torch.from_numpy(do)).sum().backward()
    f = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return out.detach().float().numpy(), x.grad.float().numpy(), f(jout), f(jgrad)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_long_attention_train_matches_jax(monkeypatch, dtype):
    """3 heads, 300 tokens: JAX pads to 384 (q tile 128, three stripes); the
    port's plain versions walk stripes of 64 rows here (five, the last
    partial), so both carry dk and dv across stripes. f32: the same math in
    another summation order (f64 softmax sums and exp in the port): forward
    to rtol 1e-5, dqkv to 2e-4. bf16: the bounds of
    ``test_attention_train_bf16_matches_jax`` (p, ds and the outputs round
    to bf16 from f32 values that differ by f32 rounding): forward within 2
    bf16 steps of the output scale and >= 95% identical, dqkv within 2% of
    its largest entry."""
    monkeypatch.setattr(la, "PLAIN_Q_STRIPE", 64)
    out, grad, jout, jgrad = _long_pair(dtype)
    if dtype == "f32":
        np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(grad, jgrad, rtol=2e-4, atol=2e-4)
    else:
        assert np.abs(out - jout).max() <= 2 * 2 ** -8 * np.abs(jout).max()
        assert np.mean(out == jout) > 0.95
        assert np.abs(grad - jgrad).max() <= 0.02 * np.abs(jgrad).max()


def test_long_attention_bwd_padding():
    """Padded keys and queries (n_valid 40 of 49, junk in the padding, and a
    nonzero ``do`` there): dq rows of padded queries and dk/dv rows of
    padded keys are exactly zero, as JAX's padded rows are (its wrapper pads
    ``do`` with zeros and masks the keys), and the valid rows equal the
    unpadded call bit for bit and JAX's dqkv to 2e-4 (f32)."""
    rng = np.random.default_rng(9)
    heads, hd, n, pad = 3, 16, 40, 9
    qkv = rng.normal(0, 1, (2, n + pad, 3 * heads * hd)).astype(np.float32)
    do = rng.normal(0, 1, (2, n + pad, heads * hd)).astype(np.float32)
    got = la.long_attention_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(do), heads, hd,
                                      n_valid=n).numpy()
    assert (got[:, n:] == 0).all()
    unpadded = la.long_attention_bwd_plain(torch.from_numpy(qkv[:, :n]),
                                           torch.from_numpy(do[:, :n]), heads, hd)
    np.testing.assert_array_equal(got[:, :n], unpadded.numpy())
    jgrad = jax.grad(lambda v: (jax_long_attention_train(v, heads, hd, 128, True)
                                * do[:, :n]).sum())(jnp.asarray(qkv[:, :n]))
    np.testing.assert_allclose(got[:, :n], np.asarray(jgrad), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("hd", [8, 16, 64, 72, 128])
def test_long_attention_train_gate_matches_jax(interpret, hd):
    """The port's gate is the JAX package's (hd a multiple of 8 and <= 128,
    N rounded up to 256 at most 4,096) for bf16 and f32, so both take the
    long-sequence branch at the same N; False outside the kernels' gates
    (other dtypes, hd not a multiple of 8, hd > 128)."""
    for n in (17, 2305, 3601, 4096, 4097, 5000):
        for dt in (torch.bfloat16, torch.float32):
            assert la.long_attention_train_available(9, hd, n, dt) == (
                jax_long_attention_train_available(9, hd, seq_len=n)), (hd, n, dt)
    assert la.long_attention_train_available(9, 64, 4096)
    assert not la.long_attention_train_available(9, 64, 4097)
    assert not la.long_attention_train_available(9, hd, 2305, torch.float16)
    assert not la.long_attention_train_available(9, 60, 2305)
    assert not la.long_attention_train_available(9, 256, 2305)
    assert la.long_attention_bwd_shapes_ok(4096, hd) and la.long_attention_shapes_ok(4096, hd)


# ---------------------------------------------------------------------------
# the loss and the train step against JAX
# ---------------------------------------------------------------------------

def _det_outputs(rng, b=2, p=16, q=QUERIES):
    return {"logits": rng.normal(0, 2, (b, p, q)).astype(np.float32),
            "pred_boxes": (1 / (1 + np.exp(-rng.normal(size=(b, p, 4))))).astype(np.float32),
            "objectness_logits": rng.normal(0, 2, (b, p)).astype(np.float32)}


def test_detection_kd_loss_matches_jax():
    """f32 log-softmax, L1 and BCE reductions in another order: rtol 1e-6;
    zero class and box loss at the teacher's own outputs (the BCE keeps its
    entropy floor), as ``tests/test_detect_training.py`` requires of JAX."""
    rng = np.random.default_rng(0)
    s, t = _det_outputs(rng), _det_outputs(rng)
    kw = dict(temperature=4.0, box_weight=1.0, obj_weight=0.25)
    loss, parts = detect_steps.detection_kd_loss(
        {k: torch.from_numpy(v) for k, v in s.items()},
        {k: torch.from_numpy(v) for k, v in t.items()}, **kw)
    jloss, jparts = jax_detect_steps.detection_kd_loss(s, t, **kw)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-6, err_msg=k)
    ts = {k: torch.from_numpy(v) for k, v in s.items()}
    _, same = detect_steps.detection_kd_loss(ts, ts, **kw)
    assert float(same["train_loss_kd"]) < 1e-6 and float(same["train_loss_box"]) == 0.0
    assert float(same["train_loss_obj"]) > 0.0
    hp = {"kd_temperature": 2.0}
    assert {k: float(v) for k, v in detect_steps.detect_loss_hparams(hp).items()} == {
        k: float(v) for k, v in jax_detect_steps.detect_loss_hparams(hp).items()}


LR, WD, CLIP = 1e-3, 1e-3, 0.05  # CLIP below the micro detector's grad norm


def _det_batches(n=3, b=4):
    rng = np.random.default_rng(11)
    return [{"image": rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8),
             "query_embeds": rng.normal(0, 1, (b, QUERIES, TEXT_DIM)).astype(np.float32),
             **{f"t_{k}": v for k, v in zip(("logits", "boxes", "obj"),
                                            _det_outputs(rng, b).values())}}
            for _ in range(n)]


@pytest.mark.parametrize("qat", [False, True, "frozen", "stride2"])
def test_detect_train_step_f32_matches_jax(interpret, monkeypatch, qat):
    """3 steps of both packages' detection train steps (cached teacher, f32,
    fast_math on so that both take their long-sequence attention branch by
    their gates: the port's plain K5a/K5b, the JAX pair in interpret mode);
    before each step
    the port takes the JAX state (params, AdamW moments, observers), the
    chaos rule of ``test_train_step_f32_matches_jax``. Bounds as there: loss
    rtol 1e-5, clipped grads rtol 1e-4, params atol 1e-5, observers rtol
    1e-4 (f32 summation order, f64 vs f32 softmax sums). ``"frozen"`` and
    ``"stride2"`` as in ``test_train_step_f32_matches_jax``: the steps after
    the first leave every observer buffer as it was in both packages (from
    power-of-two scales, ``_pow2_scales``); the activation observers see
    the first half of each batch, within rtol 1e-4 of JAX's and at some site
    unlike the whole batch's."""
    from tests.test_torch_port_train import _pow2_scales, _qconfigs

    mode, qat = qat, qat is not False
    jquant, tquant = _qconfigs(2 if mode == "stride2" else 1) if qat else (None, None)
    calls = []

    def spy(qkv, h, hd):
        calls.append(tuple(qkv.shape))
        return la.long_attention_train(qkv, h, hd)

    monkeypatch.setattr(port_vit, "long_attention_train", spy)
    kw = dict(pruned=True, qat_wrapper=qat, text_dim=TEXT_DIM, fast_math=True, **GEO)
    jdet, jcfg = jax_create_detector(quant=jquant, **kw)
    x0 = jnp.zeros((1, 32, 32, 3), jnp.float32)
    q0 = jnp.zeros((1, QUERIES, TEXT_DIM), jnp.float32)
    params = nn.meta.unbox(jdet.init(jax.random.key(0), x0, q0, observe=False))["params"]
    tx = jax_steps.make_optimizer(LR, WD, CLIP)
    opt = jax_steps.set_optimizer_hyperparams(tx.init(params), learning_rate=LR, weight_decay=WD)
    state = jax_steps.TrainState(params=params, opt_state=opt,
                                 quant_stats=jax_steps.init_quant_stats(jdet, jcfg) if qat else None,
                                 step=jnp.zeros((), jnp.int32))
    hp = {"kd_temperature": 4.0, "det_box_weight": 1.0, "det_obj_weight": 0.25}
    jhp = jax_detect_steps.detect_loss_hparams(hp)
    jsteps = {obs: jax_detect_steps.make_detect_train_step(
        None, jdet.apply, tx, qat=qat, image_size=32, donate=False, observe=obs)
        for obs in (True, False)}
    from qat_vit_tpu.data.pipeline import preprocess_fn as jprep

    @functools.partial(jax.jit, static_argnums=2)
    def jax_grads(st, batch, observe):
        x = jprep(32)(batch["image"])
        t_out = {"logits": batch["t_logits"], "pred_boxes": batch["t_boxes"],
                 "objectness_logits": batch["t_obj"]}

        def loss_fn(p):
            if observe:
                out, _ = jdet.apply({"params": p, "quant_stats": st.quant_stats}, x,
                                    batch["query_embeds"], observe=True, mutable=["quant_stats"])
            elif qat:
                out = jdet.apply({"params": p, "quant_stats": st.quant_stats}, x,
                                 batch["query_embeds"], observe=False)
            else:
                out = jdet.apply({"params": p}, x, batch["query_embeds"], observe=False)
            return jax_detect_steps.detection_kd_loss(out, t_out, temperature=4.0, box_weight=1.0,
                                                      obj_weight=0.25)[0]

        return jax.grad(loss_fn)(st.params)

    tdet, tcfg = create_detector(quant=tquant, **kw)
    assert tcfg.fast_math and tcfg.attn_kernel and tcfg.dtype == torch.float32
    jax_params.load_jax_variables(tdet, jax.device_get(params))
    tstate = steps.TrainState(tdet, steps.make_optimizer(tdet.parameters(), LR, WD, CLIP))
    tsteps = {obs: detect_steps.make_detect_train_step(None, qat=qat, image_size=32, observe=obs)
              for obs in (True, False)}
    thp = detect_steps.detect_loss_hparams(hp)

    for i, batch in enumerate(_det_batches()):
        observe = qat and not (mode == "frozen" and i > 0)
        if qat and not observe:
            state = _pow2_scales(state)
        _sync_to_jax(tdet, tstate.optimizer, state, qat)
        stats_before = {k: v.clone() for k, v in tdet.state_dict().items() if k.endswith("_val")}
        jstats_before = _leaves(jax.device_get(state.quant_stats)) if qat else {}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        g = jax_grads(state, jb, observe)
        norm = float(jnp.sqrt(sum(jnp.sum(v * v) for v in jax.tree.leaves(g))))
        assert norm > CLIP  # clipping triggers
        want_g = jax_params.params_to_state_dict(jax.device_get(
            jax.tree.map(lambda v: v / norm * CLIP, g)))
        if mode == "stride2" and i == 0:
            whole_det, _ = jax_create_detector(**kw)
            _, whole = whole_det.apply({"params": state.params, "quant_stats": state.quant_stats},
                                       jprep(32)(jb["image"]), jb["query_embeds"], observe=True,
                                       mutable=["quant_stats"])
            whole = _leaves(jax.device_get(whole["quant_stats"]))
        state, jmetrics = jsteps[observe](state, None, jb, jhp)
        n_calls = len(calls)
        tmetrics = tsteps[observe](tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, thp)
        assert len(calls) == n_calls + GEO["depth"]  # every block took the long branch
        for k in ("train_loss", "train_loss_kd", "train_loss_box", "train_loss_obj"):
            np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=1e-5,
                                       err_msg=k)
        got_g = {k: p.grad.detach().numpy() for k, p in tdet.named_parameters()}
        for k, v in want_g.items():
            np.testing.assert_allclose(got_g[k], v.numpy(), rtol=1e-4, atol=1e-7, err_msg=k)
        want_p = jax_params.params_to_state_dict(jax.device_get(state.params))
        got_p = dict(tdet.named_parameters())
        for k, v in want_p.items():
            np.testing.assert_allclose(got_p[k].detach().numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        if qat:
            j = _leaves(jax.device_get(state.quant_stats))
            t = _leaves(jax_params.buffers_to_quant_stats(tdet.state_dict()))
            assert j.keys() == t.keys() and len(j) == 2 * 25
            for k in j:
                np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)
            if not observe:
                for k, v in tdet.state_dict().items():
                    if k.endswith("_val"):
                        assert torch.equal(v, stats_before[k]), k
                assert all(np.array_equal(j[k], jstats_before[k]) for k in j)
            if mode == "stride2" and i == 0:
                assert any(not np.allclose(j[k], whole[k], rtol=1e-4) for k in j)
    assert tstate.step == 3 and int(state.step) == 3
    assert calls[0] == (4, 17, 3 * GEO["embed_dim"])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _hp(**over):
    hp = load_hparams(None)
    hp.update(task="detection", image_size=32, batch_size=8, eval_batch_size=8, epochs=2,
              num_queries=QUERIES, text_dim=TEXT_DIM, lr=1e-3, weight_decay=1e-4,
              **{k: v for k, v in GEO.items() if k != "image_size"})
    hp.update(over)
    return hp


@pytest.fixture
def long_branch():
    """The micro students (3 heads of 16, 17 tokens) take the long-sequence
    pair by the gates alone, as at 768 px: the packed width 48 is past the
    K1 shape conditions both packages share."""
    h, hd = GEO["num_heads"], GEO["embed_dim"] // GEO["num_heads"]
    for dt in (torch.bfloat16, torch.float32):
        assert not port_vit.attention_train_available(h, hd, 17, dt)
        assert port_vit.long_attention_train_available(h, hd, 17, dt)


def test_detect_trainer_phases(long_branch):
    """The trainer's defaults (bf16, fast_math): a float epoch through the
    long pair's plain versions, the QAT switch (LR x 0.5, fresh moments, the
    float parameters handed over), a QAT epoch with every observer filled,
    the eager teacher cache (64 images < 2x the planned visits), evaluate."""
    t = DetectKDTrainer(_hp(), device="cpu", data=synthetic_cifar10(n_train=32, n_test=12))
    assert t.student_float_cfg.fast_math and t.student_qat_cfg.dtype == torch.bfloat16
    assert t.teacher.module.vision.cls_token.dtype == torch.bfloat16
    assert t.queries.shape == (QUERIES, TEXT_DIM)
    np.testing.assert_allclose(np.linalg.norm(t.queries, axis=-1), 1.0, rtol=1e-6)
    launches = la.long_attention_bwd.launches
    e0 = t.train_epoch(0, limit_batches=2)
    assert e0["n_batches"] == 2 and np.isfinite(e0["train_loss"])
    assert t._teacher_mask.all()  # 2 batches x 8 x 2 epochs = 32 = all images: eager
    lr0 = t.state.optimizer.hyperparams["learning_rate"]
    t.enable_qat()
    assert t.state.optimizer.hyperparams["learning_rate"] == lr0 * 0.5
    assert not t.state.optimizer.adamw.state  # fresh moments
    for k, v in t.student_float.state_dict().items():
        assert torch.equal(v, t.student_qat.state_dict()[k]), k
    e1 = t.train_epoch(1, limit_batches=2)
    assert np.isfinite(e1["train_loss"]) and t.state.step == 4
    stats = [v for k, v in t.student_qat.state_dict().items() if k.endswith("_val")]
    assert len(stats) == 2 * 25 and all(torch.isfinite(v) for v in stats)
    ev = t.evaluate(limit_batches=1)
    assert np.isfinite(ev["box_err"]) and 0.0 <= ev["teacher_agreement"] <= 1.0
    assert la.long_attention_bwd.launches == launches  # the CPU never launches a kernel
    small = synthetic_cifar10(n_train=8, n_test=4)
    t4 = DetectKDTrainer(_hp(observer_interval=4, observer_stride=2), device="cpu", data=small)
    assert t4.train_step_qat_frozen is not None  # observer_interval runs
    assert t4.student_qat_cfg.quant.activation.observe_stride == 2
    with pytest.raises(ValueError, match="detection training supports pure-DP meshes only"):
        DetectKDTrainer(_hp(model_parallel=2), device="cpu", data=small)


def test_detect_trainer_teacher_cache(long_branch):
    """Cached teacher outputs train as the per-step teacher does (the
    teacher is frozen, the queries fixed, no augmentation): losses within
    the JAX test's rtol 2e-4 (the bf16 teacher over chunks of other sizes);
    the lazy cache fills the visited rows only and a revisit computes
    nothing."""
    data = synthetic_cifar10(n_train=64, n_test=8, seed=5)
    hp = _hp(epochs=1)
    t_off = DetectKDTrainer({**hp, "cache_teacher_logits": False}, device="cpu", data=data)
    m_off = t_off.train_epoch(0, limit_batches=2)
    t_on = DetectKDTrainer(hp, device="cpu", data=data)
    m_on = t_on.train_epoch(0, limit_batches=2)
    np.testing.assert_allclose(m_on["train_loss"], m_off["train_loss"], rtol=2e-4)
    assert t_on._teacher_mask.sum() == 2 * 8  # 16 planned visits < 32: lazy
    filled = t_on._teacher_mask.copy()
    cached = t_on._t_logits.copy()
    t_on.train_epoch(0, limit_batches=2)  # the same epoch: all hits
    np.testing.assert_array_equal(t_on._teacher_mask, filled)
    np.testing.assert_array_equal(t_on._t_logits, cached)


def test_detect_trainer_eval_convert_int8(long_branch):
    """Padded eval: 12 images as one batch of 12 and as one of 16 with 4
    masked rows give the same metrics (rtol 1e-5), for ``evaluate`` and
    ``evaluate_int8``. ``convert_int8`` on a state loaded from the JAX
    detector (params and stats after 2 observed forwards) equals JAX
    ``convert_detector``: byte-identical, the quick-GELU ``gelu_q`` qparams
    included (``test_act_output_qparams_match_jax``)."""
    from qat_vit_tpu_torch.data.pipeline import ArrayLoader

    data = synthetic_cifar10(n_train=16, n_test=12, seed=3)
    t = DetectKDTrainer(_hp(eval_batch_size=12), device="cpu", data=data)
    exact = t.evaluate()

    def rebatch(bs):
        t.eval_batch_size = bs
        t.eval_loader = ArrayLoader(data["test_images"], data["test_labels"], batch_size=bs,
                                    shuffle=False, drop_last=False)

    rebatch(16)
    padded = t.evaluate()
    for k in exact:
        np.testing.assert_allclose(padded[k], exact[k], rtol=1e-5, err_msg=k)

    jdet, jcfg = jax_create_detector(pruned=True, qat_wrapper=True, text_dim=TEXT_DIM, **GEO)
    rng = np.random.default_rng(0)
    v = nn.meta.unbox(jdet.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                jnp.zeros((1, QUERIES, TEXT_DIM)), observe=False))
    params, qs = jax.device_get(v["params"]), v["quant_stats"]
    for _ in range(2):
        x = jnp.asarray(rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32))
        _, mut = jdet.apply({"params": params, "quant_stats": qs}, x, observe=True,
                            mutable=["quant_stats"])
        qs = mut["quant_stats"]
    qs = jax.device_get(qs)
    t.enable_qat()
    jax_params.load_jax_variables(t.student_qat, params, qs)
    texp = t.convert_int8()
    jexp = jax.device_get(jax_convert_detector(params, qs, jcfg))
    j, tt = _leaves(jexp["tower"]), _leaves(texp["tower"])
    assert j.keys() == tt.keys()
    for k in j:
        np.testing.assert_array_equal(tt[k], np.asarray(j[k], np.float32), err_msg=k)
    heads = jax_params.params_to_state_dict(jexp["heads"])
    assert heads.keys() == texp["heads"].keys()
    for k in heads:
        assert torch.equal(heads[k], texp["heads"][k]), k

    i8 = t.evaluate_int8(texp)
    rebatch(12)
    i8_exact = t.evaluate_int8(texp)
    for k in i8:
        np.testing.assert_allclose(i8[k], i8_exact[k], rtol=1e-5, atol=1e-8, err_msg=k)
    assert i8_exact["int8_box_err"] < 0.05 and i8_exact["int8_top_box_agreement"] >= 0.5


def test_classification_trainer_owlv2_family(monkeypatch):
    """``student_family="owlv2"``: the teacher and student come from
    ``create_teacher/create_student("owlv2", ...)`` (the OWLv2 towers as
    classifiers; micro geometry injected here), and the trainer takes one
    float and one QAT step."""
    import qat_vit_tpu_torch.train.trainer as tr
    from qat_vit_tpu_torch.models import registry

    families = []

    def micro(fn, geo):
        def build(family, **kw):
            families.append(family)
            return fn(family, **{**kw, **geo})
        return build

    monkeypatch.setattr(tr, "create_teacher", micro(registry.create_teacher,
                                                    dict(patch_size=8, depth=1)))
    monkeypatch.setattr(tr, "create_student", micro(
        registry.create_student, {k: v for k, v in GEO.items() if k != "image_size"}))
    hp = load_hparams(None)
    hp.update(student_family="owlv2", batch_size=4, eval_batch_size=4, image_size=32, epochs=2)
    t = tr.KDQATTrainer(hp, device="cpu", data=synthetic_cifar10(n_train=16, n_test=4))
    assert families == ["owlv2", "owlv2"]
    cfg = t.student_qat_cfg
    assert (cfg.pre_norm, cfg.act, cfg.patch_bias, cfg.num_classes) == (True, "quick_gelu", False, 10)
    assert (t.teacher.cfg.embed_dim, t.teacher.cfg.num_heads) == (768, 12)
    assert np.isfinite(t.train_epoch(0, limit_batches=1)["train_loss"])
    t.enable_qat()
    assert np.isfinite(t.train_epoch(1, limit_batches=1)["train_loss"]) and t.state.step == 2
    with pytest.raises(ValueError, match="unknown model family"):
        tr.KDQATTrainer({**hp, "student_family": "resnet"}, device="cpu")


def test_owlv2_geometry_takes_the_long_branch():
    """At 768 px the OWLv2-pruned student (2,305 tokens, 9 heads of 64) is
    past kernels A and B and inside the long pair's gate, as it is in JAX."""
    from qat_vit_tpu_torch.models.owlv2_detect import detector_config
    from qat_vit_tpu_torch.ops.flash_attention_train import attention_train_available

    cfg = detector_config(pruned=True)
    assert (cfg.seq_len, cfg.num_heads, cfg.head_dim, cfg.attn_kernel) == (2305, 9, 64, True)
    assert not attention_train_available(cfg.num_heads, cfg.head_dim, cfg.seq_len)
    assert la.long_attention_train_available(cfg.num_heads, cfg.head_dim, cfg.seq_len)
