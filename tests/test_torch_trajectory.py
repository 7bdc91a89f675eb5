"""End-to-end QAT training-trajectory parity vs torch.ao.

The survey's #1 hard part: "torch.ao numeric parity of fake-quant + observers
... reproducing best_qat.pth semantics bit-for-bit in accuracy". This test is
the strongest evidence: a QAT-wrapped mini-ViT with IDENTICAL weights, data,
loss, and optimizer is trained for several steps in torch eager QAT
(QuantStub→prepare_qat model→DeQuantStub) and in this framework, and the loss
trajectories and final logits must agree to float-accumulation tolerance.
Every component is in play: 26 fake-quant sites, EMA observers, fused-kernel
qparams, STE gradients, CE loss, SGD updates.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qat_vit_tpu.models import ViTConfig, VisionTransformer, timm_vit_to_params
from qat_vit_tpu.quant import default_qat_qconfig
from qat_vit_tpu.train.losses import cross_entropy
from qat_vit_tpu.train.steps import init_quant_stats

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LR = 0.05
LS = 0.1
STEPS = 6


def _build_pair():
    from tests.test_vit_model import TorchMiniViT

    torch.manual_seed(0)
    tm = TorchMiniViT()
    for p in tm.parameters():
        if p.dim() > 1:
            torch.nn.init.normal_(p, std=0.05)
        else:
            torch.nn.init.normal_(p, std=0.02)
    cfg = ViTConfig(
        num_classes=10, image_size=32, patch_size=8, embed_dim=64, depth=2,
        num_heads=2, quant=default_qat_qconfig(), qat_wrapper=True,
    )
    params = timm_vit_to_params(
        {k: v.detach().numpy() for k, v in tm.state_dict().items()}, cfg)
    return tm, cfg, params


class _TorchQATWrapper(torch.nn.Module):
    """QuantStub → model → DeQuantStub (the reference QATWrapper,
    model_registry.py:99-124)."""

    def __init__(self, model):
        super().__init__()
        from torch.ao.quantization import DeQuantStub, QuantStub

        self.quant = QuantStub()
        self.model = model
        self.dequant = DeQuantStub()

    def forward(self, x):
        return self.dequant(self.model(self.quant(x)))


@pytest.fixture(scope="module")
def trajectory_pair():
    from torch.ao.quantization import get_default_qat_qconfig, prepare_qat

    tm, cfg, params = _build_pair()
    wrapped = _TorchQATWrapper(tm)
    wrapped.qconfig = get_default_qat_qconfig("qnnpack")
    tqat = prepare_qat(wrapped.train())
    return tqat, cfg, params


class TestQATTrajectory:
    def test_loss_trajectory_matches_torch(self, trajectory_pair):
        tqat, cfg, params = trajectory_pair
        model = VisionTransformer(cfg)
        qs = init_quant_stats(model, cfg)

        rng = np.random.default_rng(0)
        batches = [
            (rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, 8).astype(np.int64))
            for _ in range(STEPS)
        ]

        # ---- torch side: eager QAT + SGD ----
        opt = torch.optim.SGD(tqat.parameters(), lr=LR)
        t_losses = []
        for x, y in batches:
            opt.zero_grad()
            logits = tqat(torch.from_numpy(x.transpose(0, 3, 1, 2)))
            loss = torch.nn.functional.cross_entropy(
                logits, torch.from_numpy(y), label_smoothing=LS)
            loss.backward()
            opt.step()
            t_losses.append(loss.item())

        # ---- our side: same params, fused QAT step + SGD ----
        import optax

        tx = optax.sgd(LR)
        opt_state = tx.init(params)

        @jax.jit
        def step(params, opt_state, qs, x, y):
            def loss_fn(p):
                logits, mut = model.apply(
                    {"params": p, "quant_stats": qs}, x, observe=True,
                    mutable=["quant_stats"])
                return cross_entropy(logits, y, LS), mut["quant_stats"]

            (loss, new_qs), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, new_opt = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), new_opt, new_qs, loss

        j_losses = []
        p = params
        for x, y in batches:
            p, opt_state, qs, loss = step(
                p, opt_state, qs, jnp.asarray(x), jnp.asarray(y.astype(np.int32)))
            j_losses.append(float(loss))

        # trajectories agree to float-accumulation noise through 6 full
        # fake-quant train steps (26 sites, EMA observers, STE backward)
        np.testing.assert_allclose(j_losses, t_losses, rtol=2e-3, atol=2e-3)

    def test_bf16_qat_trajectory_tracks_torch(self, trajectory_pair):
        """The opt-in ``qat_amp`` step (bf16 matmuls under fake-quant,
        train/config.py) must follow the same optimization trajectory as
        torch's f32 eager QAT: fake-quant rounding (int8 grid) dominates bf16
        rounding (~3 decimal digits), so the loss curves may only drift by
        bf16 noise, not diverge. This is the numeric half of the qat_amp
        evidence; the accuracy half is the full-scale run
        (scripts/accuracy_loop.py, qat_amp variant)."""
        tqat, cfg, params = trajectory_pair
        model = VisionTransformer(dataclasses.replace(cfg, dtype=jnp.bfloat16))
        qs = init_quant_stats(model, cfg)

        rng = np.random.default_rng(0)
        batches = [
            (rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, 8).astype(np.int64))
            for _ in range(STEPS)
        ]

        import copy

        tq = copy.deepcopy(tqat)
        opt = torch.optim.SGD(tq.parameters(), lr=LR)
        t_losses = []
        for x, y in batches:
            opt.zero_grad()
            logits = tq(torch.from_numpy(x.transpose(0, 3, 1, 2)))
            loss = torch.nn.functional.cross_entropy(
                logits, torch.from_numpy(y), label_smoothing=LS)
            loss.backward()
            opt.step()
            t_losses.append(loss.item())

        import optax

        tx = optax.sgd(LR)
        opt_state = tx.init(params)

        @jax.jit
        def step(params, opt_state, qs, x, y):
            def loss_fn(p):
                logits, mut = model.apply(
                    {"params": p, "quant_stats": qs}, x, observe=True,
                    mutable=["quant_stats"])
                return cross_entropy(logits, y, LS), mut["quant_stats"]

            (loss, new_qs), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, new_opt = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), new_opt, new_qs, loss

        j_losses = []
        p = params
        for x, y in batches:
            p, opt_state, qs, loss = step(
                p, opt_state, qs, jnp.asarray(x), jnp.asarray(y.astype(np.int32)))
            j_losses.append(float(loss))

        # bf16 tolerance: ~3 decimal digits of matmul precision accumulated
        # over 6 steps; the f32 trajectory test above holds 2e-3
        np.testing.assert_allclose(j_losses, t_losses, rtol=0.02, atol=0.02)

    def test_observer_state_matches_torch_after_training(self):
        """Spot-check: the input QuantStub's running min/max trajectory
        through our full model forward equals a standalone torch stub fed the
        same tensors (the stub sees the raw input in both)."""
        from torch.ao.quantization import get_default_qat_qconfig

        _, cfg, params = _build_pair()
        model = VisionTransformer(cfg)
        qs = init_quant_stats(model, cfg)
        rng = np.random.default_rng(1)

        stub_fq = get_default_qat_qconfig("qnnpack").activation()
        stub_fq.train()
        for i in range(4):
            x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32) * (1 + i)
            stub_fq(torch.from_numpy(x))
            _, mut = model.apply(
                {"params": params, "quant_stats": qs},
                jnp.asarray(x), observe=True, mutable=["quant_stats"])
            qs = mut["quant_stats"]
        np.testing.assert_allclose(
            float(qs["input_fq"]["min_val"]),
            stub_fq.activation_post_process.min_val.item(), rtol=1e-5)
        np.testing.assert_allclose(
            float(qs["input_fq"]["max_val"]),
            stub_fq.activation_post_process.max_val.item(), rtol=1e-5)
