"""The port's model tail, on the CPU:

- ``remat`` (``ops/remat.py``): ``none``, ``dots`` and ``full`` give
  bit-identical loss, gradients and observers (exact equality), float and
  QAT, f32 and bf16 fast_math (the training attention's plain versions),
  with and without ``fq_in_kernel``, and on the long-sequence pair and the
  einsum path; the attention function runs 1 / 1 / 2 times per block per
  step; ``dots`` recomputes no GEMM in the backward and ``full`` each one
  whose output a backward reads; the recompute observes nothing; an
  unknown mode raises; the trainer's steps under ``dots`` equal ``none``'s;
- ``get_model_complexity`` equal to JAX's dict for every entry JAX's
  accepts, both refusing the ``*_torch`` entries;
- the HF ``*_torch`` entries: configs and parameter counts equal to JAX's
  (random init, built on the ``meta`` device by both), the registry's
  metadata keys JAX's;
- lazy imports: ``qat_vit_tpu_torch.search`` and ``.evaluation`` import
  with ``jax``, ``flax``, ``yaml``, ``optuna`` and ``transformers`` blocked
  (a child process), and there the HF entries raise a ``RuntimeError``
  naming ``transformers``.
"""

import collections
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

os.environ.setdefault("USE_TF", "0")  # transformers without TensorFlow

from qat_vit_tpu.models import registry as jax_registry  # noqa: E402
from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10  # noqa: E402
from qat_vit_tpu_torch.models import registry  # noqa: E402
from qat_vit_tpu_torch.models.vit import VisionTransformer, ViTConfig  # noqa: E402
from qat_vit_tpu_torch.ops import flash_attention_train as fat  # noqa: E402
from qat_vit_tpu_torch.quant.qconfig import default_qat_qconfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

MODES = ("none", "dots", "full")


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _remat_step(cfg, x, y, monkeypatch):
    """One forward (observing under QAT) + backward from a fixed state:
    (loss, grads, observer buffers, attention calls, backward op counts)."""
    module = VisionTransformer(cfg, generator=torch.Generator().manual_seed(11))
    if cfg.quant is not None:  # a first observation, so the step's stats are an EMA step
        with torch.no_grad():
            module(x, observe=True)
    calls = []
    fwd = fat.attention_fwd
    monkeypatch.setattr(fat, "attention_fwd", lambda *a, **k: calls.append(1) or fwd(*a, **k))
    loss = torch.nn.functional.cross_entropy(module(x, observe=True), y)
    bufs = {k: v.clone() for k, v in module.state_dict().items() if k.endswith("_val")}
    with _OpCount() as ops:
        loss.backward()
    monkeypatch.setattr(fat, "attention_fwd", fwd)
    grads = {k: p.grad for k, p in module.named_parameters()}
    after = {k: v for k, v in module.state_dict().items() if k.endswith("_val")}
    assert all(torch.equal(bufs[k], after[k]) for k in bufs)  # the backward observes nothing
    return loss.detach(), grads, after, len(calls), ops.counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["float", "qat", "qat_fq_in_kernel"])
def test_remat_modes_bit_identical(dtype, kind, monkeypatch):
    """Exact equality of loss, every gradient and every observer across the
    three modes (the fast_math route: the training attention kernels'
    plain versions on the CPU)."""
    base = registry.create_architecture("vit_micro_test").cfg
    quant = None if kind == "float" else default_qat_qconfig("qnnpack")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 4))
    res = {}
    for mode in MODES:
        cfg = dataclasses.replace(base, quant=quant, qat_wrapper=quant is not None, dtype=dtype,
                                  fast_math=True, fq_in_kernel=kind == "qat_fq_in_kernel",
                                  remat=mode)
        res[mode] = _remat_step(cfg, x, y, monkeypatch)
    loss, grads, obs, _, _ = res["none"]
    for mode in MODES:
        got = res[mode]
        assert torch.equal(got[0], loss), mode
        assert got[1].keys() == grads.keys() and all(torch.equal(got[1][k], grads[k])
                                                     for k in grads), mode
        assert got[2].keys() == obs.keys() and all(torch.equal(got[2][k], obs[k])
                                                   for k in obs), mode
    depth = base.depth
    assert [res[m][3] for m in MODES] == [depth, depth, 2 * depth]
    # the backward's GEMMs: dots recomputes none; full recomputes a block's
    # GEMMs up to the last one whose output a backward reads (the recompute
    # stops there): fc2's output feeds only the residual add in the float
    # block, its fake-quant's STE mask in the QAT block
    mm = {m: res[m][4]["mm"] for m in MODES}
    assert mm["dots"] == mm["none"]
    assert mm["full"] == mm["none"] + (3 if kind == "float" else 4) * depth
    assert not any(res[m][4]["aminmax"] for m in MODES)


@pytest.mark.parametrize("route", ["long", "einsum"])
@pytest.mark.parametrize("kind", ["float", "qat"])
def test_remat_other_routes_bit_identical(route, kind, monkeypatch):
    """The long-sequence pair (K5a / K5b's plain versions, reached as the
    detection tests do by closing the short kernels' gate) and the einsum
    path (no fast_math) in bf16: exact equality across the three modes;
    ``dots`` runs no GEMM or batched product again, and no mode's backward
    observes."""
    from qat_vit_tpu_torch.models import vit as vit_module
    from qat_vit_tpu_torch.ops import long_attention as la

    if route == "long":
        monkeypatch.setattr(vit_module, "attention_train_available", lambda *a, **k: False)
    base = registry.create_architecture("vit_micro_test").cfg
    quant = None if kind == "float" else default_qat_qconfig("qnnpack")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 4))
    calls = []
    train = la.long_attention_train
    monkeypatch.setattr(vit_module, "long_attention_train",
                        lambda *a, **k: calls.append(1) or train(*a, **k))
    res = {}
    for mode in MODES:
        cfg = dataclasses.replace(base, quant=quant, qat_wrapper=quant is not None,
                                  dtype=torch.bfloat16, fast_math=route == "long", remat=mode)
        n = len(calls)
        loss, grads, obs, _, ops = _remat_step(cfg, x, y, monkeypatch)
        res[mode] = (loss, grads, obs, len(calls) - n, ops)
    loss, grads, obs = res["none"][:3]
    for mode in MODES:
        got = res[mode]
        assert torch.equal(got[0], loss), mode
        assert all(torch.equal(got[1][k], grads[k]) for k in grads), mode
        assert all(torch.equal(got[2][k], obs[k]) for k in obs), mode
    # the step's forward (after a first observation under QAT); full runs
    # each block's attention again in the backward
    fwd = base.depth * (2 if kind == "qat" else 1)
    want = [fwd, fwd, fwd + base.depth] if route == "long" else [0, 0, 0]
    assert [res[m][3] for m in MODES] == want
    for op in ("mm", "bmm"):
        assert res["dots"][4][op] == res["none"][4][op], op
    assert not any(res[m][4]["aminmax"] for m in MODES)


def test_remat_unknown_mode_raises():
    with pytest.raises(ValueError, match="remat"):
        ViTConfig(remat="some")
    with pytest.raises(ValueError, match="remat"):
        registry.create_architecture("vit_micro_test", remat="dot")
    assert ViTConfig(remat="dots").remat == "dots"


def test_trainer_steps_under_remat_match_none():
    """KDQATTrainer at its defaults (bf16, fast_math, fq_in_kernel): one
    float and two QAT steps under ``dots`` and ``full`` equal ``none``'s
    (losses, parameters, observers)."""
    from qat_vit_tpu_torch.train.config import DEFAULT_HPARAMS
    from qat_vit_tpu_torch.train.trainer import KDQATTrainer

    data = synthetic_cifar10(n_train=64, n_test=16, seed=3)
    teacher = registry.create_model("vit_micro_test", generator=torch.Generator().manual_seed(1))
    student = registry.create_model("vit_micro_test", generator=torch.Generator().manual_seed(2))
    runs = {}
    for mode in MODES:
        hp = dict(DEFAULT_HPARAMS, batch_size=16, image_size=32, epochs=1, remat=mode)
        t = KDQATTrainer(hp, device="cpu", data=data, student=student, teacher=teacher)
        assert t.student_qat_cfg.remat == mode and t.student_qat_cfg.fq_in_kernel
        losses = [t.train_epoch(0, limit_batches=1)["train_loss"]]
        t.enable_qat()
        losses.append(t.train_epoch(1, limit_batches=2)["train_loss"])
        runs[mode] = (losses, {k: v.clone() for k, v in t.state.module.state_dict().items()})
    for mode in MODES:
        assert runs[mode][0] == runs["none"][0]
        sd, want = runs[mode][1], runs["none"][1]
        assert all(torch.equal(sd[k], want[k]) for k in want), mode


# ---------------------------------------------------------------------------
# the registry's tail
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jax_registry.list_available_models()))
def test_get_model_complexity_matches_jax(name):
    try:
        want = jax_registry.get_model_complexity(name)
    except ValueError as e:
        with pytest.raises(ValueError, match="external"):
            registry.get_model_complexity(name)
        assert "external" in str(e) and name.endswith("_torch")
        return
    assert registry.get_model_complexity(name) == want


def test_registry_metadata_matches_jax():
    """The same entries with the same task, input size and
    ``tpu_compatible`` (the descriptions are each package's own)."""
    keys = ("task", "input_size", "tpu_compatible")
    got, want = registry.list_available_models(), jax_registry.list_available_models()
    assert got.keys() == want.keys()
    assert {n: {k: v[k] for k in keys} for n, v in got.items()} == {
        n: {k: v[k] for k in keys} for n, v in want.items()}
    assert all(set(v) == set(want[n]) for n, v in got.items())


@pytest.mark.parametrize("name,kw", [("owlv2_base_teacher_torch", {"pretrained": False}),
                                     ("owlv2_student_pruned_torch", {}),
                                     ("owlv2_student_pruned_torch", {"depth_ratio": 0.5,
                                                                     "head_ratio": 0.5})])
def test_hf_entries_match_jax(name, kw):
    """Both packages' HF entries on the ``meta`` device (random init, no
    weights allocated): the same config and parameter count."""
    with torch.device("meta"):
        got = registry.create_model(name, **kw)
        want = jax_registry.create_model(name, **kw)
    assert type(got).__name__ == type(want).__name__ == "Owlv2ForObjectDetection"
    assert got.config.to_dict() == want.config.to_dict()
    n = sum(p.numel() for p in got.parameters())
    assert n == sum(p.numel() for p in want.parameters()) and n > 0


def test_hf_student_missing_checkpoint_warns():
    from qat_vit_tpu_torch.models.owlv2 import build_owlv2_student_torch

    with torch.device("meta"), pytest.warns(RuntimeWarning, match="random init"):
        model = build_owlv2_student_torch(checkpoint_path="/nonexistent/student.pth")
    assert model.config.vision_config.num_hidden_layers == 9


def test_registry_self_test(capsys):
    assert registry.self_test(device="cpu")
    out = capsys.readouterr().out
    assert "student QAT fwd: (2, 10)" in out and "'params': 21669514" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            registry.self_test()


def test_search_and_evaluation_import_lazily():
    """``import qat_vit_tpu_torch.search`` / ``.evaluation`` with jax, flax,
    yaml, optuna and transformers blocked; none of them imported; the HF
    entries raise a ``RuntimeError`` naming transformers."""
    code = textwrap.dedent("""
        import sys
        for m in ("jax", "flax", "yaml", "optuna", "transformers", "qat_vit_tpu"):
            sys.modules[m] = None
        import qat_vit_tpu_torch.search as s
        import qat_vit_tpu_torch.evaluation as e
        from qat_vit_tpu_torch.models import registry
        assert s.HAS_OPTUNA is False and callable(s.run_optuna_search)
        assert callable(e.evaluate_checkpoint) and callable(e.compare_checkpoints)
        for name in ("owlv2_base_teacher_torch", "owlv2_student_pruned_torch"):
            try:
                registry.create_model(name, pretrained=False) if "teacher" in name else \\
                    registry.create_model(name)
            except RuntimeError as err:
                assert "transformers" in str(err)
            else:
                raise AssertionError(name)
        assert registry.get_model_complexity("vit_micro_test")["params"] == 425098
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "flax", "yaml", "optuna", "transformers", "qat_vit_tpu")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(Path(__file__).parents[1]))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
