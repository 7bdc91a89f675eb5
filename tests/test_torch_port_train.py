"""Port parity: the KD + QAT training path of ``qat_vit_tpu_torch`` against
``qat_vit_tpu`` at micro size, on the CPU.

- the training attention (``attention_train`` / ``attention_train_fq``): the
  port's plain versions of kernels A and B against the JAX Pallas kernels in
  interpret mode, forward and qkv gradient, f32 and bf16;
- the STE ``fake_quantize``, the KD losses;
- the f32 train step (the trainer's strict-parity mode: ``amp`` and
  ``qat_amp`` off, so both packages take the einsum attention): loss, grads,
  params and every observer over 3 AdamW steps, float and QAT, with
  clipping that triggers;
- the bf16 + fast_math model on the einsum path against JAX;
- the port's fused-fq branch against its own unfused chain (bit-identical);
- a trainer smoke run: 2 epochs, QAT switch, convert, int8 eval;
- the QAT loss trajectory three ways: torch.ao, the JAX package, the port.

Inputs are numpy, seeded, and go to both packages.
"""

import dataclasses

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from qat_vit_tpu.models.registry import create_model as jax_create_model
from qat_vit_tpu.ops.flash_attention_train import attention_train as jax_attention_train
from qat_vit_tpu.ops.flash_attention_train import attention_train_fq as jax_attention_train_fq
from qat_vit_tpu.quant.fake_quant import fake_quantize as jax_fake_quantize
from qat_vit_tpu.train import losses as jax_losses
from qat_vit_tpu.train import steps as jax_steps
from qat_vit_tpu_torch.models import jax_params
from qat_vit_tpu_torch.models.registry import create_model
from qat_vit_tpu_torch.ops import flash_attention as fa
from qat_vit_tpu_torch.ops import flash_attention_train as fat
from qat_vit_tpu_torch.quant.fake_quant import fake_quantize
from qat_vit_tpu_torch.train import losses
from qat_vit_tpu_torch.train import steps


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, N, H, HD = 3, 17, 2, 64
QS = (4.2 / 255, 127.0)  # clips the N(0, 1) qkv beyond ~±2.1: the STE mask is not all ones


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        if hasattr(v, "items"):
            out.update(_leaves(v, name))
        elif v is not None:
            out[name] = np.asarray(v, np.float32)
    return out


# ---------------------------------------------------------------------------
# training attention: plain kernels A + B vs the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------

def _attention_pair(dtype, fq):
    """(port out, port dqkv, JAX out, JAX dqkv) for one seeded case; the
    cotangent is ``do`` (cast to the qkv dtype inside both backward passes)."""
    rng = np.random.default_rng(7)
    qkv = rng.normal(0, 1, (B, N, 3 * H * HD)).astype(np.float32)
    do = rng.normal(0, 1, (B, N, H * HD)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)

    def jfn(q):
        if fq:
            qs = jnp.asarray([QS], jnp.float32)
            return jax_attention_train_fq(q, qs, H, HD, 0, 255, 4, True)
        return jax_attention_train(q, H, HD, 4, True)

    jq = jnp.asarray(qkv).astype(jdt)
    jout = jfn(jq)
    jgrad = jax.grad(lambda q: (jfn(q).astype(jnp.float32) * do).sum())(jq)

    x = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    qs = torch.tensor(QS, dtype=torch.float32)
    out = fat.attention_train_fq(x, qs, H, HD, 0, 255) if fq else fat.attention_train(x, H, HD)
    (out.float() * torch.from_numpy(do)).sum().backward()
    f = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return out.detach().float().numpy(), x.grad.float().numpy(), f(jout), f(jgrad)


@pytest.mark.parametrize("fq", [False, True])
def test_attention_train_f32_matches_jax(fq):
    """f32: the same math in another summation order (f64 softmax sums and
    exp in the port): forward to rtol 1e-5, dqkv to 2e-4 (the TPU kernel
    test's bounds)."""
    out, grad, jout, jgrad = _attention_pair("f32", fq)
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, jgrad, rtol=2e-4, atol=2e-4)
    if fq:
        assert (grad == 0).mean() > 0.01 and (jgrad == 0).sum() == (grad == 0).sum()


@pytest.mark.parametrize("fq", [False, True])
def test_attention_train_bf16_matches_jax(fq):
    """bf16 (the training dtype): p, ds and the outputs are rounded to bf16
    from f32 values that differ by f32 rounding, so an element may land one
    bf16 step (2^-8 relative) away. Forward: within 2 bf16 steps of the
    output scale; dqkv: within 2% of its largest entry (one flipped ds
    rounding moves a sum of N terms by up to a step of that term)."""
    out, grad, jout, jgrad = _attention_pair("bf16", fq)
    assert np.abs(out - jout).max() <= 2 * 2 ** -8 * np.abs(jout).max()
    assert np.abs(grad - jgrad).max() <= 0.02 * np.abs(jgrad).max()
    assert np.mean(out == jout) > 0.95


def test_attention_train_available_gate():
    """The Hopper gate: bf16 or f32, JAX's K1 shape conditions and hd % 8
    (the kernels stream past their shared-memory plans); True on the CPU as
    well."""
    assert fat.attention_train_available(2, 64, 17)  # micro
    assert fat.attention_train_available(6, 64, 197)  # ViT-S
    assert fat.attention_train_available(12, 64, 197)  # ViT-B
    assert fat.attention_train_available(6, 64, 197, torch.float32)
    assert fat.attention_train_available(6, 64, 204, torch.float32)  # past kernel B's f32 plan
    assert not fat.attention_train_available(6, 64, 197, torch.float16)
    assert fat.attention_train_available(6, 64, 400)  # past kernel B's old budget
    assert not fat.attention_train_available(6, 64, 513)  # JAX's VMEM budget
    assert not fat.attention_train_available(6, 60, 197)
    assert not fat.attention_train_available(2, 256, 17)


def test_float_output_attention_forms():
    """``fused_attention_qkv`` without ``out_q`` is the float form
    (kernel A's plain version on the CPU), and in_fq equals fake-quant then
    attention, bit for bit."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(0, 1, (2, N, 3 * H * HD)).astype(np.float32)).bfloat16()
    out = fa.fused_attention_qkv(qkv, H, HD)
    assert out.dtype == torch.bfloat16 and torch.equal(out, fa.attention_fwd_plain(qkv, H, HD))
    qs = torch.tensor(QS, dtype=torch.float32)
    fused = fa.attention_fwd(qkv, H, HD, qs=qs, in_fq=(0, 255))
    assert torch.equal(fused, fa.attention_fwd(fake_quantize(qkv, qs[0], qs[1], 0, 255), H, HD))


# ---------------------------------------------------------------------------
# STE fake-quant and losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fake_quantize_ste_matches_jax(dtype):
    """Forward identical (the same f32 ops), gradient identical (the STE
    mask passes g where the unclipped grid value is in range)."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1.5, (64, 33)).astype(np.float32)
    g = rng.normal(0, 1, (64, 33)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    s, zp = np.float32(0.02), np.float32(121.0)
    jx = jnp.asarray(x).astype(jdt)
    jy = jax_fake_quantize(jx, s, zp, 0, 255)
    jg = jax.grad(lambda v: (jax_fake_quantize(v, s, zp, 0, 255).astype(jnp.float32) * g).sum())(jx)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ty = fake_quantize(tx, torch.tensor(s), torch.tensor(zp), 0, 255)
    (ty.float() * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(ty.detach().float().numpy(), np.asarray(jy.astype(jnp.float32)))
    np.testing.assert_array_equal(tx.grad.float().numpy(), np.asarray(jg.astype(jnp.float32)))
    assert (tx.grad == 0).any()


def test_losses_match_jax():
    """f32 log-softmax reductions in another order: rtol 1e-6."""
    rng = np.random.default_rng(2)
    s = rng.normal(0, 3, (16, 10)).astype(np.float32)
    t = rng.normal(0, 3, (16, 10)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    ts, tt, ty = torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(y).long()
    for ls in (0.0, 0.1):
        np.testing.assert_allclose(float(losses.cross_entropy(ts, ty, ls)),
                                   float(jax_losses.cross_entropy(s, y, ls)), rtol=1e-6)
        # torch's own label-smoothing convention
        np.testing.assert_allclose(float(losses.cross_entropy(ts, ty, ls)),
                                   float(torch.nn.functional.cross_entropy(ts, ty, label_smoothing=ls)),
                                   rtol=1e-6)
    np.testing.assert_allclose(float(losses.kd_kl_divergence(ts, tt, 4.0)),
                               float(jax_losses.kd_kl_divergence(s, t, 4.0)), rtol=1e-6)
    loss, parts = losses.kd_loss(ts, tt, ty, alpha=0.5, temperature=4.0, label_smoothing=0.1)
    jloss, jparts = jax_losses.kd_loss(s, t, y, alpha=0.5, temperature=4.0, label_smoothing=0.1)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-6)
    assert int(losses.top1_correct(ts, ty)) == int(jax_losses.top1_correct(s, y))


# ---------------------------------------------------------------------------
# the f32 train step, 3 AdamW steps, float and QAT
# ---------------------------------------------------------------------------

LR, WD, CLIP = 1e-3, 1e-3, 0.05  # CLIP well below the micro model's grad norm (~0.3-3)


def _batches(n=3, b=4):
    rng = np.random.default_rng(11)
    return [{"image": rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8),
             "label": rng.integers(0, 10, b).astype(np.int32),
             "teacher_logits": rng.normal(0, 2, (b, 10)).astype(np.float32)} for _ in range(n)]


def _port_grads(module):
    return {k: p.grad.detach().numpy().copy() for k, p in module.named_parameters()}


def _sync_to_jax(module, optimizer, state, qat):
    """Load the JAX state (params, AdamW moments and count, observers) into
    the port's module and optimizer, in place."""
    sd = jax_params.params_to_state_dict(jax.device_get(state.params))
    if qat:
        sd.update(jax_params.quant_stats_to_buffers(jax.device_get(state.quant_stats)))
    module.load_state_dict(sd)
    adam = next(s for s in jax.tree.leaves(state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))
    mu = jax_params.params_to_state_dict(jax.device_get(adam.mu))
    nu = jax_params.params_to_state_dict(jax.device_get(adam.nu))
    for name, p in module.named_parameters():
        optimizer.adamw.state[p] = {"step": torch.tensor(float(adam.count)),
                                    "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}


def _qconfigs(stride):
    """The JAX and port default qconfigs with ``observe_stride`` on the
    activation observers."""
    from qat_vit_tpu.quant.qconfig import default_qat_qconfig as jax_qconfig
    from qat_vit_tpu_torch.quant.qconfig import default_qat_qconfig

    out = []
    for qc in (jax_qconfig(), default_qat_qconfig()):
        out.append(dataclasses.replace(
            qc, activation=dataclasses.replace(qc.activation, observe_stride=stride)))
    return out


def _pow2_scales(state):
    """The JAX state with every observer's (min, max) set to (-128, 127) x
    2^k, the least power of two that covers the observed range: both
    packages' qparams rules (affine and symmetric) then give the scale 2^k
    exactly, and ``x / scale`` has one rounding however it is computed."""
    def site(stats):
        if "min_val" not in stats:
            return {k: site(v) for k, v in stats.items()}
        lo, hi = float(stats["min_val"]), float(stats["max_val"])
        scale = 2.0 ** np.ceil(np.log2(max(-lo / 128, hi / 127, 2.0 ** -14)))
        return {"min_val": jnp.float32(-128 * scale), "max_val": jnp.float32(127 * scale)}

    return jax_steps.TrainState(params=state.params, opt_state=state.opt_state,
                                quant_stats=site(jax.device_get(state.quant_stats)),
                                step=state.step)


@pytest.mark.parametrize("qat", [False, True, "frozen", "stride2"])
def test_train_step_f32_matches_jax(qat):
    """3 steps of both packages' train steps; before each, the port takes
    the JAX state (params, AdamW moments, observers), so each step is held
    from the same start. (Free-running, the QAT trajectories part after one
    step: params that differ by f32 noise (~1e-6) move ~1% of the weights
    whose fake-quant value sits within that of a rounding tie by one grid
    step, which is a different forward, not a fault.)

    Loss to rtol 1e-5; the clipped grads to rtol 1e-4 (f32 GEMM and
    softmax sums in another order, after the global-norm scaling); params
    to atol 1e-5 = 1% of lr (AdamW normalizes each update to ~lr; where an
    element's gradient is as small as eps = 1e-8, f32 cancellation noise in
    it is a large share of it and moves that update by up to ~1% of lr,
    measured 3e-6 at most); observer min/max to rtol 1e-4 (the same
    activations in another summation order).

    ``"frozen"``: the first QAT step observes, the next two are the
    observer-frozen step (``observe=False``, the trainer's
    ``observer_interval``): every observer buffer stays as it was, exactly,
    in both packages, and loss, grads and params keep the bounds above.
    ``"stride2"``: the activation observers see the first half of each
    batch (``observer_stride`` 2): the statistics within rtol 1e-4 of JAX's,
    and at some site unlike those of the whole batch. The frozen steps start
    from statistics with power-of-two scales (:func:`_pow2_scales`): XLA's
    fused program divides by a scale as a product with its reciprocal, which
    moves fake-quant rounding ties at other scales (measured with the
    observed scales: one weight's gradient 1.12e-5 op by op, 2.12e-5 jitted,
    in JAX alone, 3% of lr in its AdamW update)."""
    mode, qat = qat, qat is not False
    jquant, tquant = _qconfigs(2 if mode == "stride2" else 1) if qat else (None, None)
    jm = jax_create_model("vit_micro_test", qat_wrapper=qat, quant=jquant)
    params = nn.meta.unbox(jm.module.init(jax.random.key(0), jm.example_input(1),
                                          observe=False))["params"]
    tx = jax_steps.make_optimizer(LR, WD, CLIP)
    opt = jax_steps.set_optimizer_hyperparams(tx.init(params), learning_rate=LR, weight_decay=WD)
    qs = jax_steps.init_quant_stats(jm.module, jm.cfg) if qat else None
    state = jax_steps.TrainState(params=params, opt_state=opt, quant_stats=qs,
                                 step=jnp.zeros((), jnp.int32))
    hp = {"kd_alpha": 0.5, "kd_temperature": 4.0, "label_smoothing": 0.1}
    jsteps = {obs: jax_steps.make_train_step(None, jm.module.apply, tx, qat=qat, image_size=32,
                                             donate=False, observe=obs) for obs in (True, False)}
    from qat_vit_tpu.data.pipeline import preprocess_fn as jprep

    def jax_clipped_grads(st, batch, observe):
        x = jax.device_get(jnp.asarray(batch["image"]))

        def loss_fn(p):
            v = {"params": p, "quant_stats": st.quant_stats} if qat else {"params": p}
            out = jm.module.apply(v, jprep(32)(x), observe=observe,
                                  mutable=["quant_stats"] if observe else False)
            logits = out[0] if observe else out
            return jax_losses.kd_loss(logits, batch["teacher_logits"], batch["label"],
                                      alpha=0.5, temperature=4.0, label_smoothing=0.1)[0]

        g = jax.grad(loss_fn)(st.params)
        norm = float(jnp.sqrt(sum(jnp.sum(v * v) for v in jax.tree.leaves(g))))
        assert norm > CLIP  # clipping triggers
        return jax_params.params_to_state_dict(jax.device_get(
            jax.tree.map(lambda v: v / norm * CLIP, g)))

    tm = create_model("vit_micro_test", qat_wrapper=qat, quant=tquant)
    jax_params.load_jax_variables(tm.module, jax.device_get(params))
    tstate = steps.TrainState(tm.module, steps.make_optimizer(tm.module.parameters(), LR, WD, CLIP))
    tsteps = {obs: steps.make_train_step(None, qat=qat, image_size=32, observe=obs)
              for obs in (True, False)}
    thp = steps.loss_hparams(hp)

    for i, batch in enumerate(_batches()):
        observe = qat and not (mode == "frozen" and i > 0)
        if qat and not observe:
            state = _pow2_scales(state)
        _sync_to_jax(tm.module, tstate.optimizer, state, qat)
        stats_before = {k: v.clone() for k, v in tm.module.state_dict().items()
                        if k.endswith("_val")}
        jstats_before = _leaves(jax.device_get(state.quant_stats)) if qat else {}
        want_g = jax_clipped_grads(state, batch, observe)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if mode == "stride2" and i == 0:
            _, whole = jax_create_model("vit_micro_test", qat_wrapper=True).module.apply(
                {"params": state.params, "quant_stats": state.quant_stats},
                jprep(32)(jbatch["image"]), observe=True, mutable=["quant_stats"])
            whole = _leaves(jax.device_get(whole["quant_stats"]))
        state, jmetrics = jsteps[observe](state, None, jbatch, jax_steps.loss_hparams(hp))
        tbatch = {"image": torch.from_numpy(batch["image"]),
                  "label": torch.from_numpy(batch["label"]).long(),
                  "teacher_logits": torch.from_numpy(batch["teacher_logits"])}
        tmetrics = tsteps[observe](tstate, tbatch, thp)
        for k in ("train_loss", "train_loss_ce", "train_loss_kd", "train_acc"):
            np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=1e-5,
                                       err_msg=k)
        got_g = _port_grads(tm.module)
        for k, v in want_g.items():
            np.testing.assert_allclose(got_g[k], v.numpy(), rtol=1e-4, atol=1e-7, err_msg=k)
        want_p = jax_params.params_to_state_dict(jax.device_get(state.params))
        got_p = dict(tm.module.named_parameters())
        for k, v in want_p.items():
            np.testing.assert_allclose(got_p[k].detach().numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        if qat:
            j = _leaves(jax.device_get(state.quant_stats))
            t = _leaves(jax_params.buffers_to_quant_stats(tm.module.state_dict()))
            assert j.keys() == t.keys() and len(j) == 2 * 26
            for k in j:
                np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)
            if not observe:
                for k, v in tm.module.state_dict().items():
                    if k.endswith("_val"):
                        assert torch.equal(v, stats_before[k]), k
                assert all(np.array_equal(j[k], jstats_before[k]) for k in j)
            if mode == "stride2" and i == 0:
                assert any(not np.allclose(j[k], whole[k], rtol=1e-4) for k in j)
    assert tstate.step == 3 and int(state.step) == 3


def test_optimizer_pieces():
    """optax's clip rule (no epsilon, none below the limit), the
    hyperparameter setter, the observer reset and the observer-frozen step
    (the optimizer steps, no observer buffer moves)."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    norm = steps.clip_by_global_norm_(g, 1.0)
    assert float(norm) == 5.0 and torch.equal(g[0], torch.tensor([3.0, 4.0]) * (1.0 / 5.0))
    g = [torch.tensor([0.3, 0.4])]
    steps.clip_by_global_norm_(g, 1.0)
    assert torch.equal(g[0], torch.tensor([0.3, 0.4]))
    m = create_model("vit_micro_test", qat_wrapper=True, generator=torch.Generator().manual_seed(0))
    opt = steps.make_optimizer(m.module.parameters(), 1e-3, 1e-2)
    steps.set_optimizer_hyperparams(opt, learning_rate=5e-4)
    assert opt.hyperparams == {"learning_rate": 5e-4, "weight_decay": 1e-2}
    with pytest.raises(KeyError):
        steps.set_optimizer_hyperparams(opt, momentum=0.9)
    m.module(torch.zeros(2, 32, 32, 3), observe=True)
    steps.init_quant_stats(m.module)
    stats = [v for k, v in m.module.state_dict().items() if k.endswith("_val")]
    assert len(stats) == 52 and all(torch.isinf(v) for v in stats)
    # the observer-frozen QAT step runs: the optimizer steps, no observer moves
    m.module(torch.zeros(2, 32, 32, 3), observe=True)
    before = {k: v.clone() for k, v in m.module.state_dict().items()}
    frozen = steps.make_train_step(None, qat=True, image_size=32, observe=False)
    state = steps.TrainState(m.module, opt)
    batch = {"image": torch.zeros(2, 32, 32, 3, dtype=torch.uint8), "label": torch.tensor([1, 2]),
             "teacher_logits": torch.zeros(2, 10)}
    assert np.isfinite(float(frozen(state, batch, steps.loss_hparams(
        {"kd_alpha": 0.5, "kd_temperature": 4.0, "label_smoothing": 0.1}))["train_loss"]))
    after = m.module.state_dict()
    assert state.step == 1 and all(torch.equal(v, after[k]) for k, v in before.items()
                                   if k.endswith("_val"))
    assert not torch.equal(before["head.weight"], after["head.weight"])
    from qat_vit_tpu_torch.train.trainer import trainer_mesh

    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        trainer_mesh({"model_parallel": 2})


# ---------------------------------------------------------------------------
# the bf16 + fast_math model, and the fused-fq branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qat", [False, True])
def test_bf16_fast_math_model_matches_jax(qat):
    """bf16 compute, bf16 softmax and tanh-GELU on the einsum path
    (``attn_kernel=False``) in both packages: bf16 rounds at other places
    in the two frameworks (torch rounds fused elementwise chains once, XLA
    per op), so the logits agree to bf16 noise: rel L2 <= 3e-2, and the
    observer stats of the QAT forward to 3% of their range."""
    kw = dict(dtype=jnp.bfloat16, fast_math=True, attn_kernel=False)
    jm = jax_create_model("vit_micro_test", qat_wrapper=qat, **kw)
    v = nn.meta.unbox(jm.module.init(jax.random.key(1), jm.example_input(1), observe=False))
    x = np.random.default_rng(5).normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    tm = create_model("vit_micro_test", qat_wrapper=qat, dtype=torch.bfloat16, fast_math=True,
                      attn_kernel=False)
    jax_params.load_jax_variables(tm.module, jax.device_get(v["params"]))
    if qat:
        jl, mut = jm.module.apply(v, jnp.asarray(x), observe=True, mutable=["quant_stats"])
    else:
        jl = jm.module.apply(v, jnp.asarray(x), observe=False)
    with torch.no_grad():
        tl = tm.module(torch.from_numpy(x), observe=qat)
    assert tl.dtype == torch.float32
    jl = np.asarray(jl)
    assert np.linalg.norm(tl.numpy() - jl) <= 3e-2 * np.linalg.norm(jl)
    if qat:
        j = _leaves(jax.device_get(mut["quant_stats"]))
        t = _leaves(jax_params.buffers_to_quant_stats(tm.module.state_dict()))
        for k in j:
            site = k.rsplit("/", 1)[0]
            span = j[f"{site}/max_val"] - j[f"{site}/min_val"]
            assert abs(t[k] - j[k]) <= 0.03 * span + 1e-6, k


def _qat_step(cfg, params, stats, x):
    from qat_vit_tpu_torch.models.vit import VisionTransformer

    m = VisionTransformer(cfg)
    m.load_state_dict({**params, **stats})
    loss = (m(x, observe=True) ** 2).sum()
    loss.backward()
    grads = {k: p.grad.clone() for k, p in m.named_parameters()}
    new_stats = {k: v.clone() for k, v in m.state_dict().items() if k.endswith("_val")}
    return loss.detach(), grads, new_stats


def test_fq_in_kernel_is_bit_identical_to_unfused_chain():
    """The port's kernel branch (``fq_in_kernel``: observer update, then
    ``attention_train_fq``) against its unfused chain (the qkv fake-quant,
    then ``attention_train``), through the plain kernels on the CPU: loss,
    grads and observer stats identical, from fresh (±inf) observers and
    from calibrated ones."""
    from qat_vit_tpu_torch.models.vit import VisionTransformer

    base = create_model("vit_micro_test", qat_wrapper=True, dtype=torch.bfloat16,
                        fast_math=True, generator=torch.Generator().manual_seed(0)).cfg
    assert fat.attention_train_available(base.num_heads, base.head_dim, base.seq_len, base.dtype)
    init = VisionTransformer(base, generator=torch.Generator().manual_seed(1)).state_dict()
    params = {k: v for k, v in init.items() if not k.endswith("_val")}
    stats = {k: v for k, v in init.items() if k.endswith("_val")}
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (3, 32, 32, 3)).astype(np.float32))
    launches = fa.attention_fwd.launches
    for _ in range(2):
        l0, g0, s0 = _qat_step(base, params, stats, x)
        l1, g1, s1 = _qat_step(dataclasses.replace(base, fq_in_kernel=True), params, stats, x)
        assert torch.equal(l0, l1)
        for k in g0:
            assert torch.equal(g0[k], g1[k]), k
        for k in s0:
            assert torch.equal(s0[k], s1[k]), k
        stats = s0
    assert fa.attention_fwd.launches == launches  # the CPU never launches a kernel


# ---------------------------------------------------------------------------
# trainer smoke
# ---------------------------------------------------------------------------

def test_trainer_smoke():
    """Micro student and teacher, 2 epochs of 2 batches under the trainer's
    defaults (bf16, fast_math, fq_in_kernel: the plain kernels on the CPU),
    the QAT switch between them, convert and int8 eval."""
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.train.config import load_hparams
    from qat_vit_tpu_torch.train.trainer import KDQATTrainer

    hp = load_hparams(None)
    hp.update(batch_size=8, eval_batch_size=16, image_size=32, epochs=2)
    g = torch.Generator().manual_seed(0)
    t = KDQATTrainer(hp, device="cpu", data=synthetic_cifar10(n_train=64, n_test=32),
                     student=create_model("vit_micro_test", qat_wrapper=True, generator=g),
                     teacher=create_model("vit_micro_test", generator=g))
    assert t.student_float_cfg.dtype == torch.bfloat16 and t.student_float_cfg.fast_math
    assert t.student_qat_cfg.fq_in_kernel and t.student_qat_cfg.dtype == torch.bfloat16
    e0 = t.train_epoch(0, limit_batches=2)
    assert e0["n_batches"] == 2 and np.isfinite(e0["train_loss"])
    assert 0.0 <= t.evaluate(limit_batches=1) <= 1.0
    lr0 = t.state.optimizer.hyperparams["learning_rate"]
    t.enable_qat()
    assert t.state.optimizer.hyperparams["learning_rate"] == lr0 * 0.5
    assert not t.state.optimizer.adamw.state  # fresh moments
    for k, v in t.student_float.state_dict().items():
        assert torch.equal(v, t.student_qat.state_dict()[k]), k
    e1 = t.train_epoch(1, limit_batches=2)
    assert np.isfinite(e1["train_loss"]) and t.state.step == 4
    stats = [v for k, v in t.student_qat.state_dict().items() if k.endswith("_val")]
    assert len(stats) == 52 and all(torch.isfinite(v) for v in stats)
    assert 0.0 <= t.evaluate(limit_batches=1) <= 1.0
    export = t.convert_int8()
    assert export["blocks"]["0"]["qkv"]["w_int8"].dtype == torch.int8
    assert 0.0 <= t.evaluate_int8(export, limit_batches=1) <= 1.0
    data = synthetic_cifar10(n_train=16, n_test=8)
    t4 = KDQATTrainer({**hp, "observer_interval": 4, "observer_stride": 2}, device="cpu",
                      data=data, student=create_model("vit_micro_test", qat_wrapper=True),
                      teacher=create_model("vit_micro_test"))
    assert t4.train_step_qat_frozen is not None  # observer_interval runs
    assert t4.student_qat_cfg.quant.activation.observe_stride == 2
    assert t4.student_qat_cfg.quant.weight.observe_stride == 1
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        KDQATTrainer({**hp, "model_parallel": 2}, device="cpu", data=data)


# ---------------------------------------------------------------------------
# three ways: torch.ao eager QAT, the JAX package and the port
# ---------------------------------------------------------------------------

def test_qat_trajectory_three_ways():
    """``tests/test_torch_trajectory.py``'s mini-ViT (D 64, 2 heads, 26
    fake-quant sites, identical weights and data, CE + SGD) trained for 6
    steps by torch.ao eager QAT, the JAX package and the port (f32): the
    port's loss trajectory stays within that file's f32 bound (rtol 2e-3)
    of both, and within 1e-4 of JAX's (the same observers and qparam rules,
    summation order aside)."""
    import copy

    import optax
    from torch.ao.quantization import get_default_qat_qconfig, prepare_qat

    from qat_vit_tpu.models import VisionTransformer as JaxViT
    from qat_vit_tpu.train.steps import init_quant_stats as jax_init_quant_stats
    from qat_vit_tpu_torch.models.vit import VisionTransformer, ViTConfig
    from qat_vit_tpu_torch.quant.qconfig import default_qat_qconfig
    from tests.test_torch_trajectory import LR, LS, STEPS, _build_pair, _TorchQATWrapper

    tm, cfg, params = _build_pair()
    wrapped = _TorchQATWrapper(copy.deepcopy(tm))
    wrapped.qconfig = get_default_qat_qconfig("qnnpack")
    tqat = prepare_qat(wrapped.train())
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, 8).astype(np.int64)) for _ in range(STEPS)]

    opt = torch.optim.SGD(tqat.parameters(), lr=LR)
    ao = []
    for x, y in batches:
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(
            tqat(torch.from_numpy(x.transpose(0, 3, 1, 2))), torch.from_numpy(y),
            label_smoothing=LS)
        loss.backward()
        opt.step()
        ao.append(loss.item())

    jm = JaxViT(cfg)
    tx = optax.sgd(LR)

    @jax.jit
    def jstep(p, o, qs, x, y):
        def loss_fn(p):
            logits, mut = jm.apply({"params": p, "quant_stats": qs}, x, observe=True,
                                   mutable=["quant_stats"])
            return jax_losses.cross_entropy(logits, y, LS), mut["quant_stats"]

        (loss, qs), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, qs, loss

    p, o, qs, jx = params, tx.init(params), jax_init_quant_stats(jm, cfg), []
    for x, y in batches:
        p, o, qs, loss = jstep(p, o, qs, jnp.asarray(x), jnp.asarray(y.astype(np.int32)))
        jx.append(float(loss))

    pm = VisionTransformer(ViTConfig(num_classes=10, image_size=32, patch_size=8, embed_dim=64,
                                     depth=2, num_heads=2, quant=default_qat_qconfig(),
                                     qat_wrapper=True))
    jax_params.load_jax_variables(pm, jax.device_get(params))
    popt = torch.optim.SGD(pm.parameters(), lr=LR)
    port = []
    for x, y in batches:
        popt.zero_grad()
        loss = losses.cross_entropy(pm(torch.from_numpy(x), observe=True), torch.from_numpy(y), LS)
        loss.backward()
        popt.step()
        port.append(loss.item())

    np.testing.assert_allclose(port, ao, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(port, jx, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(port, jx, rtol=1e-4)
