"""Port parity for evaluation (``qat_vit_tpu_torch/evaluation``), on the CPU,
against the JAX package.

One set of files written by the JAX package for the micro ViT (float
params, ``best_qat``: params + quant_stats, ``best_converted``: the int8
export) is evaluated by both packages on 100 synthetic test images at batch
64, so the last batch (36 images) is padded. The test labels are the JAX
float model's own predictions, so every count is informative. Held:

- the correct counts of the fake-quant model and of both int8 modes
  (``exact``, and ``preset``, which is the exact path off the card in both
  packages) identical; the float model's logits within 1e-5 of JAX's
  (f32 in both, the einsum attention: only the summation order differs)
  and its count all 100, as JAX's by construction; for ``qnnpack`` at the native size and
  ``fbgemm`` with an ``image_size`` override (48 px);
- the comparator's table identical, with its per-row error; each package's
  ``main`` prints the same ``top1_acc=`` line;
- the refusals (no CUDA device, an unknown serving mode, int8 without a
  checkpoint).
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from qat_vit_tpu.data import preprocess as jax_preprocess
from qat_vit_tpu.evaluation import comparator as jax_comparator
from qat_vit_tpu.evaluation import evaluator as jax_evaluator
from qat_vit_tpu.models import create_model as jax_create_model
from qat_vit_tpu.quant.qconfig import default_qat_qconfig as jax_qconfig
from qat_vit_tpu.serve.int8_vit import convert_vit as jax_convert_vit
from qat_vit_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
from qat_vit_tpu_torch.data.pipeline import preprocess_fn
from qat_vit_tpu_torch.evaluation import comparator, evaluator
from qat_vit_tpu_torch.evaluation.evaluator import _load_module_state
from qat_vit_tpu_torch.models.registry import create_model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

N_TEST, BATCH = 100, 64


_INIT = {}


def _jax_init(q, x):
    """JAX's init of the micro ViT (one jitted call, once); another image
    size takes the same tree with a fresh position embedding of its length."""
    if not _INIT:
        v = nn.meta.unbox(jax.jit(lambda k: q.module.init(k, x[:1], observe=False))(
            jax.random.key(3)))
        _INIT.update(jax.tree.map(np.asarray, v))
    params = dict(_INIT["params"])
    if params["pos_embed"].shape[1] != q.cfg.seq_len:
        rng = np.random.default_rng(4)
        params["pos_embed"] = (0.02 * rng.standard_normal(
            (1, q.cfg.seq_len, q.cfg.embed_dim))).astype(np.float32)
    return {"params": params, "quant_stats": _INIT["quant_stats"]}


def _jax_files(tmp, backend: str, image_size: int):
    """JAX-written checkpoints of the micro ViT and a data dir whose test
    labels are the JAX float model's argmax over its images."""
    size = {"image_size": image_size} if image_size else {}
    data = synthetic_cifar10(n_train=16, n_test=N_TEST, seed=7)
    q = jax_create_model("vit_micro_test", qat_wrapper=True, quant=jax_qconfig(backend), **size)
    x = jax_preprocess(jnp.asarray(data["test_images"]), size=q.cfg.image_size)
    variables = _jax_init(q, x)
    params = variables["params"]
    _, mut = jax.jit(lambda v, xs: q.module.apply(v, xs, observe=True, mutable=["quant_stats"]))(
        variables, x[:32])
    qs = mut["quant_stats"]
    f = jax_create_model("vit_micro_test", **size)
    logits = np.asarray(jax.jit(lambda p, xs: f.module.apply({"params": p}, xs, observe=False))(
        params, x))
    data["test_labels"] = logits.argmax(-1).astype(data["test_labels"].dtype)
    (tmp / "data").mkdir()
    np.savez(tmp / "data" / "cifar10.npz", **data)
    paths = {k: str(tmp / f"{k}.msgpack") for k in ("float", "best_qat", "best_converted")}
    jax_save_checkpoint(paths["float"], {"params": params})
    jax_save_checkpoint(paths["best_qat"], {"params": params, "quant_stats": qs})
    jax_save_checkpoint(paths["best_converted"], jax_convert_vit(params, qs, q.cfg))
    return paths, str(tmp / "data"), logits, data


CASES = [("qnnpack", 0), ("fbgemm", 48)]
_FILES = {}


def _files(case, tmp_path_factory):
    """The JAX files of one (backend, image_size) case, written once."""
    if case not in _FILES:
        tmp = tmp_path_factory.mktemp(f"eval_{case[0]}_{case[1]}")
        _FILES[case] = case + _jax_files(tmp, *case)
    return _FILES[case]


# every case: fake-quant and exact int8; the native qnnpack case also the
# float model and the preset (the exact path off the card in both packages)
EVAL_CASES = ([(CASES[0], m) for m in ("float", "int8_preset")]
              + [(c, m) for c in CASES for m in ("qat_wrapper", "int8_exact")])


def _both(path, data_dir, **kw):
    """(port, JAX) accuracy of one evaluation."""
    common = dict(data_dir=data_dir, batch_size=BATCH, **kw)
    return (evaluator.evaluate_checkpoint("vit_micro_test", path, device="cpu", **common),
            jax_evaluator.evaluate_checkpoint("vit_micro_test", path, **common))


@pytest.mark.parametrize("case,mode", EVAL_CASES,
                         ids=[f"{c[0]}-{c[1] or 'native'}-{m}" for c, m in EVAL_CASES])
def test_evaluate_checkpoint_matches_jax(case, mode, tmp_path_factory):
    backend, image_size, paths, data_dir, _, _ = _files(case, tmp_path_factory)
    kw = {"qat_backend": backend, "image_size": image_size}
    if mode == "float":
        # the labels are JAX's float predictions (the float model JAX's
        # evaluator builds, through the same jitted apply): JAX counts all
        got = evaluator.evaluate_checkpoint("vit_micro_test", paths["float"], device="cpu",
                                            data_dir=data_dir, batch_size=BATCH,
                                            image_size=image_size)
        want = 1.0
    elif mode == "qat_wrapper":
        got, want = _both(paths["best_qat"], data_dir, qat_wrapper=True, **kw)
    else:
        got, want = _both(paths["best_converted"], data_dir, int8=True,
                          serving=mode.split("_")[1], **kw)
    assert round(got * N_TEST) == round(want * N_TEST)
    assert got == want


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{c[1] or 'native'}" for c in CASES])
def test_float_logits_match_jax(case, tmp_path_factory):
    """The port's float model, loaded as ``evaluate_checkpoint`` loads it,
    against JAX's logits: atol 1e-5 (f32, the summation order differs)."""
    backend, image_size, paths, _, want, data = _files(case, tmp_path_factory)
    bundle = create_model("vit_micro_test", generator=torch.Generator().manual_seed(0),
                          **({"image_size": image_size} if image_size else {}))
    _load_module_state(bundle.module, paths["float"])
    x = preprocess_fn(bundle.cfg.image_size)(torch.from_numpy(data["test_images"]))
    with torch.no_grad():
        got = bundle.module(x, observe=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_comparator_and_mains_match_jax(tmp_path, tmp_path_factory, capsys):
    """The comparator's rows and table (a broken row recorded, not raised)
    and each package's CLI line."""
    _, _, paths, data_dir, _, _ = _files(CASES[0], tmp_path_factory)
    items = [("student_qat", paths["best_qat"], dict(qat_wrapper=True)),
             ("student_quant", paths["best_converted"], dict(int8=True)),
             ("broken", str(tmp_path / "missing.msgpack"), {})]
    got = comparator.compare_checkpoints(
        [comparator.CompareItem(n, "vit_micro_test", p, **kw) for n, p, kw in items],
        data_dir=data_dir, batch_size=BATCH, device="cpu")
    want = jax_comparator.compare_checkpoints(
        [jax_comparator.CompareItem(n, "vit_micro_test", p, **kw) for n, p, kw in items],
        data_dir=data_dir, batch_size=BATCH)
    assert [(r["name"], r["acc"]) for r in got] == [(r["name"], r["acc"]) for r in want]
    assert got[2]["error"] and want[2]["error"]
    table = comparator.format_table(got)
    assert table == jax_comparator.format_table(want) and "ERROR" in table
    argv = ["--model", "vit_micro_test", "--ckpt", paths["best_converted"], "--int8",
            "--data-dir", data_dir, "--batch-size", str(BATCH), "--serving", "preset"]
    capsys.readouterr()
    evaluator.main(argv, device="cpu")
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    jax_evaluator.main(argv)
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_line == jax_line and port_line.startswith("top1_acc=")
    comparator.main(["--model", "vit_micro_test", "--qat-ckpt", paths["best_qat"],
                     "--quant-ckpt", paths["best_converted"], "--data-dir", data_dir,
                     "--batch-size", str(BATCH)], device="cpu")
    port_table = capsys.readouterr().out.strip()
    jax_comparator.main(["--model", "vit_micro_test", "--qat-ckpt", paths["best_qat"],
                         "--quant-ckpt", paths["best_converted"], "--data-dir", data_dir,
                         "--batch-size", str(BATCH)])
    assert port_table == capsys.readouterr().out.strip()


def test_evaluator_refusals(tmp_path):
    np.savez(tmp_path / "cifar10.npz", **synthetic_cifar10(n_train=8, n_test=200, seed=1))
    loader = evaluator.build_cifar10_loader(str(tmp_path), batch_size=64, limit=2)
    assert len(loader) == 2 and loader.batch_size == 64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            evaluator.evaluate_checkpoint("vit_micro_test", None, data_dir=str(tmp_path))
    with pytest.raises(ValueError, match="requires --ckpt"):
        evaluator.evaluate_checkpoint("vit_micro_test", None, int8=True, device="cpu",
                                      data_dir=str(tmp_path), limit_batches=1)
    with pytest.raises(ValueError, match="serving"):
        evaluator.evaluate_checkpoint("vit_micro_test", "x.msgpack", int8=True, device="cpu",
                                      serving="fast", data_dir=str(tmp_path), limit_batches=1)
