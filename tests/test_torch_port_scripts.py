"""Port parity: the functions users run end to end
(``qat_vit_tpu_torch/scripts/``) against the JAX package's ``scripts/``,
loaded from their files (nothing in ``scripts/`` changes), at micro size on
the CPU.

- ``data/cifar10.synthetic_cifar10_hard``: arrays identical to JAX's;
- ``convert_teacher``: the msgpack bytes of JAX's script for one micro
  ``.pth``;
- ``pretrain_teacher``: the port's micro teacher read by the JAX package's
  ``load_checkpoint`` with the keys and shapes of a JAX-built template, and
  taken by both packages' ``teacher_ckpt``;
- ``accuracy_loop``: the hp dict each ``phase_final`` hands to
  ``train_main``, ``phase_teacher``'s argv and ``phase_search``'s
  ``SearchConfig`` equal JAX's (the callees stubbed in both modules);
  ``REPORT.md`` / ``REPORT.json`` byte-identical from the same stubbed
  summaries and evaluations; a micro run through every phase on the port
  alone (its model names pointed at ``vit_micro_test``);
- ``detect_loop``: ``_hp`` and ``phase_report`` the same way, ``--micro``
  end to end;
- ``validate_real``: ``--dry-run``, and the refusal without
  ``--allow-synthetic``;
- the three shell wrappers under ``bash`` with a stub ``python`` on
  ``PATH`` that records its argv, against JAX's wrappers.
"""

import argparse
import dataclasses
import functools
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10_hard
from qat_vit_tpu_torch.models.jax_params import state_dict_to_params
from qat_vit_tpu_torch.models.registry import create_model
from qat_vit_tpu_torch.models.torch_convert import params_to_timm_vit
from qat_vit_tpu_torch.scripts import (
    accuracy_loop,
    convert_teacher,
    detect_loop,
    pretrain_teacher,
    validate_real,
)
from qat_vit_tpu_torch.train import trainer as port_trainer
from qat_vit_tpu_torch.train.config import dump_flat_yaml
from qat_vit_tpu_torch.train.trainer import EpochResult, KDQATTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = "vit_micro_test"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script(name):
    """``scripts/{name}.py`` loaded from its file, its compile-cache call
    made a no-op while it loads (the JAX package's own tests load them so)."""
    import qat_vit_tpu.utils.compile_cache as cc

    enable = cc.enable_compile_cache
    cc.enable_compile_cache = lambda *a, **k: None
    try:
        if name == "pretrain_teacher":  # accuracy_loop imports it as scripts.pretrain_teacher
            return importlib.import_module("scripts.pretrain_teacher")
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        cc.enable_compile_cache = enable


def _micro_pth(path):
    """A timm-layout ``.pth`` of the micro ViT (seed 0), as torch saves one."""
    module = create_model(MICRO, generator=torch.Generator().manual_seed(0)).module
    state = params_to_timm_vit(state_dict_to_params(module.state_dict()), module.cfg)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}, path)
    return path


def _seed_data(workdir, n_train, n_test, seed=0):
    """``workdir/data/cifar10.npz`` from the hard synthetic set (the loops'
    idempotent data phase then skips generating 50k images)."""
    d = os.path.join(workdir, "data")
    os.makedirs(d, exist_ok=True)
    np.savez_compressed(os.path.join(d, "cifar10.npz"),
                        **synthetic_cifar10_hard(n_train, n_test, seed=seed))
    return d


# ---------------------------------------------------------------------------
# data, conversion, the teacher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_train,n_test,seed", [(2048, 512, 0), (64, 16, 3)])
def test_synthetic_cifar10_hard_matches_jax(n_train, n_test, seed):
    """The hard synthetic set: every array identical to JAX's (values,
    dtypes, shapes) for the same ``(n_train, n_test, seed)``."""
    from qat_vit_tpu.data.cifar10 import synthetic_cifar10_hard as jax_hard

    want = jax_hard(n_train, n_test, seed=seed)
    got = synthetic_cifar10_hard(n_train, n_test, seed=seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["train_images"].shape == (n_train, 32, 32, 3)


def test_convert_teacher_writes_jax_bytes(tmp_path, capsys):
    """One micro ``.pth`` through both packages' ``convert_teacher``: the
    msgpack and its JSON sidecar byte-identical, the same printed line."""
    src = _micro_pth(str(tmp_path / "micro.pth"))
    outs = {}
    for tag, main in (("jax", _jax_script("convert_teacher").main), ("port", convert_teacher.main)):
        dst = str(tmp_path / f"{tag}.msgpack")
        main([src, dst, "--model", MICRO, "--num-classes", "10"])
        line = capsys.readouterr().out.strip().splitlines()[-1]
        with open(dst, "rb") as f, open(dst + ".json") as g:
            outs[tag] = (f.read(), g.read(), line.replace(dst, "DST"))
    assert outs["port"] == outs["jax"]


def test_pretrained_teacher_loads_in_both_packages(tmp_path):
    """The port's micro teacher (one epoch of 2 batches): JAX's
    ``load_checkpoint`` reads it with the keys and shapes of a JAX-built
    template; JAX's ``load_model_params`` and the port's trainer take it as
    ``teacher_ckpt`` (the port's teacher then holds its weights)."""
    import jax
    import flax.linen as nn

    from qat_vit_tpu.models.registry import create_model as jax_create_model
    from qat_vit_tpu.train.trainer import load_model_params as jax_load_model_params
    from qat_vit_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint

    data_dir = _seed_data(str(tmp_path), 64, 16)
    out = str(tmp_path / "teacher")
    pretrain_teacher.main(["--data-dir", data_dir, "--output-dir", out, "--arch", MICRO,
                           "--epochs", "1", "--batch-size", "16", "--eval-batch-size", "16",
                           "--image-size", "32", "--limit-train-batches", "2",
                           "--limit-eval-batches", "1"], device="cpu")
    ckpt = os.path.join(out, "teacher.msgpack")
    with open(ckpt + ".json") as f:
        meta = json.load(f)
    assert meta["arch"] == MICRO and meta["kind"] == "teacher-pretrain" and meta["epoch"] == 0
    bundle = jax_create_model(MICRO)
    template = nn.meta.unbox(bundle.module.init(
        jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32), observe=False))["params"]
    restored = jax_load_checkpoint(ckpt)
    want = {jax.tree_util.keystr(k): v.shape
            for k, v in jax.tree_util.tree_leaves_with_path(template)}
    got = {jax.tree_util.keystr(k): np.asarray(v).shape
           for k, v in jax.tree_util.tree_leaves_with_path(restored["params"])}
    assert restored.keys() == {"params"} and got == want
    jax_params = jax_load_model_params(ckpt, bundle.cfg)
    assert {jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(jax_params)} \
        == set(want)
    hp = dict(port_trainer.DEFAULT_HPARAMS, teacher_ckpt=ckpt, image_size=32, batch_size=8,
              eval_batch_size=8)
    t = KDQATTrainer(hp, device="cpu", data=synthetic_cifar10_hard(16, 8, seed=1),
                     student=create_model(MICRO, qat_wrapper=True),
                     teacher=create_model(MICRO, generator=torch.Generator().manual_seed(5)))
    held = state_dict_to_params(t.teacher.module.state_dict())  # the frozen bf16 teacher
    for name, v in restored["params"]["head"].items():
        want = torch.tensor(np.asarray(v, np.float32)).to(torch.bfloat16).float().numpy()
        assert np.array_equal(held["head"][name], want), name


# ---------------------------------------------------------------------------
# the accuracy loop
# ---------------------------------------------------------------------------

def _fake_results(epochs):
    """``train_main``'s results for a stub: two epochs' ``EpochResult``s."""
    return {"best_acc": 0.5, "final_quant_acc": 0.25,
            "results": [EpochResult(e, 1.0 / (e + 1), 0.1 * e, 0.2 * e, e > 0, 100.0 + e)
                        for e in range(epochs)]}


def test_accuracy_loop_inputs_match_jax(tmp_path, monkeypatch):
    """``phase_final``'s hp (f32, amp, obs4, the float run; with and without
    a ``best_params.yaml``), ``phase_teacher``'s argv and ``phase_search``'s
    ``SearchConfig`` equal JAX's for the same arguments; the summaries
    (``RESULT.json``) byte-identical."""
    import qat_vit_tpu.search.driver as jax_driver
    import qat_vit_tpu.train.trainer as jax_trainer

    jloop = _jax_script("accuracy_loop")
    jpt = _jax_script("pretrain_teacher")
    seen = {"jax": [], "port": []}

    def stub(tag):
        def train_main(hp, **kw):
            seen[tag].append(("final", dict(hp)))
            os.makedirs(hp["output_dir"])  # as train_main makes it
            return _fake_results(2)

        def pt_main(argv, **kw):
            seen[tag].append(("teacher", list(argv)))
            out = argv[argv.index("--output-dir") + 1]  # the file the phase checks for
            os.makedirs(out)
            open(os.path.join(out, "teacher.msgpack"), "w").close()

        def search(cfg, **kw):
            seen[tag].append(("search", dataclasses.asdict(cfg)))
            return {}
        return train_main, pt_main, search

    for attr, val in zip(("train_main", "main", "run_optuna_search"), stub("jax")):
        monkeypatch.setattr({"train_main": jax_trainer, "main": jpt,
                             "run_optuna_search": jax_driver}[attr], attr, val)
    train_main, pt_main, search = stub("port")
    monkeypatch.setattr(accuracy_loop, "train_main", train_main)
    monkeypatch.setattr(accuracy_loop.pretrain_teacher, "main", pt_main)
    monkeypatch.setattr(accuracy_loop, "run_optuna_search", search)
    best = str(tmp_path / "best_params.yaml")
    with open(best, "w") as f:
        f.write(dump_flat_yaml({"lr": 2e-4, "weight_decay": 1e-3, "label_smoothing": 0.05,
                                "kd_temperature": 3.0, "kd_temp": 3.0, "kd_alpha": 0.6,
                                "qat_start_epoch": 4, "epochs": 6, "batch_size": 64,
                                "qat_backend": "qnnpack"}))
    for tag, loop in (("jax", jloop), ("port", accuracy_loop)):
        w = str(tmp_path / tag)
        kw = {} if tag == "jax" else {"device": "cpu"}
        loop.phase_teacher(w, "D", 3, **kw)
        loop.phase_search(w, "D", "T.msgpack", 4, 5, **kw)
        assert loop.phase_search(w, "D", "T.msgpack", 0, 5, **kw) == ""
        for bp in (best, ""):
            loop.phase_final(w, "D", "T.msgpack", bp, 5, qat_amp=False, tag=f"f32{bool(bp)}",
                             **kw)
            loop.phase_final(w, "D", "T.msgpack", bp, 5, qat_amp=True, tag=f"amp{bool(bp)}",
                             **kw)
            loop.phase_final(w, "D", "T.msgpack", bp, 5, qat_amp=True,
                             extra={"observer_interval": 4}, tag=f"obs4{bool(bp)}", **kw)
            loop.phase_final(w, "D", "T.msgpack", bp, 3, qat_amp=False,
                             extra={"qat_start_epoch": 10 ** 9}, tag=f"float{bool(bp)}", **kw)
    assert [k for k, _ in seen["port"]] == [k for k, _ in seen["jax"]] == \
        ["teacher", "search"] + ["final"] * 8
    for (kind, p), (_, j) in zip(seen["port"], seen["jax"]):
        if kind == "final":
            p["output_dir"] = p["output_dir"].replace(str(tmp_path / "port"), "W")
            j["output_dir"] = j["output_dir"].replace(str(tmp_path / "jax"), "W")
            p["mlflow_uri"] = p["mlflow_uri"].replace(str(tmp_path / "port"), "W")
            j["mlflow_uri"] = j["mlflow_uri"].replace(str(tmp_path / "jax"), "W")
            assert p.pop("query_seed") == -1  # the port's one key beyond JAX's
        if kind == "search":
            for d in (p, j):
                d["output_dir"] = os.path.basename(d["output_dir"])
                d["mlflow_uri"] = os.path.basename(d["mlflow_uri"])
        if kind == "teacher":
            p[p.index("--output-dir") + 1] = os.path.basename(p[p.index("--output-dir") + 1])
            j[j.index("--output-dir") + 1] = os.path.basename(j[j.index("--output-dir") + 1])
        assert p == j, kind
    for tag in ("f32True", "amp", "obs4", "floatFalse"):
        for sub in os.listdir(tmp_path / "jax"):
            if sub.startswith(f"final_{tag}"):
                with open(tmp_path / "jax" / sub / "RESULT.json") as f, \
                        open(tmp_path / "port" / sub / "RESULT.json") as g:
                    assert json.loads(f.read().replace(str(tmp_path / "jax"), "W")) == \
                        json.loads(g.read().replace(str(tmp_path / "port"), "W"))


def _fake_evaluate(model, ckpt=None, **kw):
    """A stub ``evaluate_checkpoint``: a value of the call's arguments."""
    key = (model, os.path.basename(ckpt or ""), kw.get("qat_wrapper", False),
           kw.get("int8", False), kw.get("serving", "exact"))
    return (sum(map(ord, repr(key))) % 997) / 997.0


def test_accuracy_loop_report_matches_jax(tmp_path, monkeypatch):
    """``phase_report`` from the same summaries, extras and stubbed
    ``evaluate_checkpoint`` values: ``REPORT.md`` and ``REPORT.json``
    byte-identical across packages, and the same printed table."""
    import qat_vit_tpu.evaluation.evaluator as jax_evaluator

    jloop = _jax_script("accuracy_loop")
    monkeypatch.setattr(jax_evaluator, "evaluate_checkpoint", _fake_evaluate)
    monkeypatch.setattr(accuracy_loop, "evaluate_checkpoint",
                        lambda *a, device=None, **kw: _fake_evaluate(*a, **kw))
    epochs = [{"epoch": e, "train_loss": 2.0 - e, "qat_acc": 0.3 + 0.01 * e,
               "quant_acc": 0.29 + 0.02 * e, "qat_enabled": e > 0, "imgs_per_sec": 512.5 + e}
              for e in range(3)]
    finals = {"f32": {"output_dir": "W/final_f32", "epochs": epochs},
              "qat_amp(bf16)": {"output_dir": "W/final_amp", "epochs": epochs[::-1]}}
    extras = {"ptq": {"calib_batches": 20, "float_top1": 0.41, "ptq_per_tensor_top1": 0.3,
                      "ptq_per_channel_top1": 0.35},
              "per_channel": {"int8_per_channel_top1": 0.33, "ckpt": "W/pc.msgpack"},
              "per_channel_baseline": 0.31, "per_channel_variant": "qat_amp(bf16)",
              "qat_int8_baseline": 0.31}
    files = {}
    for tag, loop in (("jax", jloop), ("port", accuracy_loop)):
        w = tmp_path / tag
        w.mkdir()
        kw = {} if tag == "jax" else {"device": "cpu"}
        loop.phase_report(str(w), "D", "T.msgpack", finals, extras, **kw)
        files[tag] = [(w / n).read_bytes() for n in ("REPORT.md", "REPORT.json")]
    assert files["port"] == files["jax"]
    report = json.loads(files["port"][1])
    assert set(report["variants"]["f32"]) == {
        "fp32_top1", "fakequant_top1", "int8_top1", "int8_preset_top1", "trainer_last_epoch",
        "int8_minus_fakequant", "preset_minus_exact"}


def test_accuracy_loop_micro_end_to_end(tmp_path, monkeypatch):
    """Every phase of the port's loop on micro models (``STUDENT`` /
    ``TEACHER``, the teacher's ``--arch`` and the trainers' models pointed at
    ``vit_micro_test``, 32
    px, 2 train batches an epoch): the teacher pretrained, a 2-trial
    search, the f32 / amp / float runs, PTQ, per-channel, the report with
    every key of JAX's and each top-1 in [0, 1]; a second run skips every
    phase (idempotent)."""
    w = str(tmp_path / "acc")
    _seed_data(w, 512, 64)
    monkeypatch.setattr(accuracy_loop, "STUDENT", MICRO)
    monkeypatch.setattr(accuracy_loop, "TEACHER", MICRO)
    pt_main = pretrain_teacher.main
    monkeypatch.setattr(pretrain_teacher, "main", lambda argv, **kw: pt_main(
        argv + ["--arch", MICRO, "--image-size", "32", "--batch-size", "16",
                "--eval-batch-size", "16", "--limit-train-batches", "2",
                "--limit-eval-batches", "2"], **kw))
    monkeypatch.setattr(accuracy_loop, "SearchConfig", functools.partial(
        accuracy_loop.SearchConfig, micro=True, batch_size=16, eval_batch_size=16,
        limit_train_batches=2, limit_eval_batches=2))
    load = accuracy_loop.load_hparams
    monkeypatch.setattr(accuracy_loop, "load_hparams", lambda path: dict(
        load(path), image_size=32, limit_train_batches=2))
    train_main = accuracy_loop.train_main
    monkeypatch.setattr(accuracy_loop, "train_main", lambda hp, **kw: train_main(
        hp, student=create_model(MICRO, qat_wrapper=True), teacher=create_model(MICRO), **kw))
    monkeypatch.setattr(accuracy_loop, "phase_ptq", functools.partial(
        accuracy_loop.phase_ptq, calib_batches=2, batch_size=16))
    argv = ["--workdir", w, "--teacher-epochs", "1", "--trials", "2", "--search-epochs", "2",
            "--final-epochs", "3"]
    accuracy_loop.main(argv, device="cpu")
    for f in ("teacher/teacher.msgpack", "search/best_params.yaml", "final_f32/RESULT.json",
              "final_amp/RESULT.json", "final_float/PTQ_RESULT.json",
              "final_amp/best_converted_perchannel.msgpack", "REPORT.md"):
        assert os.path.isfile(os.path.join(w, f)), f
    with open(os.path.join(w, "REPORT.json")) as f:
        report = json.load(f)
    assert set(report) == {"teacher", "variants", "ptq", "per_channel", "per_channel_baseline",
                           "per_channel_variant", "qat_int8_baseline"}
    assert set(report["variants"]) == {"f32", "qat_amp(bf16)"}
    tops = [report["teacher"], report["per_channel"]["int8_per_channel_top1"]]
    tops += [report["ptq"][k] for k in ("float_top1", "ptq_per_tensor_top1",
                                        "ptq_per_channel_top1")]
    for v in report["variants"].values():
        tops += [v[k] for k in ("fp32_top1", "fakequant_top1", "int8_top1", "int8_preset_top1")]
        assert v["trainer_last_epoch"]["qat_enabled"]
        # off the card the preset is the exact path
        assert v["preset_minus_exact"] == 0.0
    assert all(0.0 <= t <= 1.0 for t in tops), tops
    monkeypatch.setattr(accuracy_loop, "train_main", None)  # a second run trains nothing
    monkeypatch.setattr(pretrain_teacher, "main", None)
    accuracy_loop.main(argv + ["--phase", "final"], device="cpu")


# ---------------------------------------------------------------------------
# the detection loop
# ---------------------------------------------------------------------------

def _detect_args(workdir, micro, **over):
    args = dict(workdir=workdir, image_size=768, batch_size=32, epochs=6, qat_start_epoch=3,
                delta_batches=60, limit_eval_batches=0, seed=0, micro=micro, phase="all")
    args.update(over)
    return argparse.Namespace(**args)


@pytest.mark.parametrize("micro", [False, True])
def test_detect_loop_hp_and_report_match_jax(tmp_path, micro):
    """``_hp`` (with and without ``--micro``, with overrides) equals JAX's;
    ``phase_report`` from the same cache delta and final results writes
    byte-identical ``REPORT_detect.md`` / ``.json``."""
    jloop = _jax_script("detect_loop")
    args = _detect_args("W", micro, batch_size=8, epochs=2, qat_start_epoch=1)
    for over in ({}, {"cache_teacher_logits": False, "epochs": 1}):
        want, got = jloop._hp(args, "D", **over), detect_loop._hp(args, "D", **over)
        assert got.pop("query_seed") == -1
        assert got == want
    delta = {"cache_on": {"imgs_per_sec": 31.25, "epoch_seconds": 2.0, "batches": 2,
                          "wall_with_setup": 9.5},
             "cache_off": {"imgs_per_sec": 12.5, "epoch_seconds": 5.0, "batches": 2,
                           "wall_with_setup": 12.0}, "speedup": 2.5}
    final = {"results": [{"epoch": e, "train_loss": 1.5 - e, "box_err": 0.1 / (e + 1),
                          "teacher_agreement": 0.5 + 0.1 * e, "imgs_per_sec": 20.0 + e,
                          "qat_enabled": e > 0} for e in range(2)],
             "int8": {"int8_box_err": 0.00123, "int8_top_box_agreement": 0.875},
             "hp": {"epochs": 2}}
    files = {}
    for tag, loop in (("jax", jloop), ("port", detect_loop)):
        w = tmp_path / tag
        w.mkdir()
        loop.phase_report(_detect_args(str(w), micro, batch_size=8, epochs=2,
                                       qat_start_epoch=1), delta, final)
        files[tag] = [(w / n).read_bytes() for n in ("REPORT_detect.md", "REPORT_detect.json")]
    assert files["port"] == files["jax"]


def test_detect_loop_micro_end_to_end(tmp_path):
    """``detect_loop --micro`` on the port at 32 px: the cache delta on and
    off, ``detect_train_main`` through a float and a QAT epoch with the int8
    export's metrics, both reports; every metric finite (on a seeded set of
    32 / 16 images: its data phase then skips the 512 / 128 of ``--micro``)."""
    w = str(tmp_path / "det")
    _seed_data(w, 32, 16)
    detect_loop.main(["--workdir", w, "--micro", "--image-size", "32", "--batch-size", "4",
                      "--epochs", "2", "--qat-start-epoch", "1", "--delta-batches", "1",
                      "--limit-eval-batches", "1"], device="cpu")
    with open(os.path.join(w, "cache_delta.json")) as f:
        delta = json.load(f)
    assert delta["cache_on"]["batches"] == 1 and delta["speedup"] > 0
    with open(os.path.join(w, "REPORT_detect.json")) as f:
        report = json.load(f)
    rows = report["final"]["results"]
    assert [r["qat_enabled"] for r in rows] == [False, True]
    assert all(np.isfinite(r[k]) for r in rows for k in ("train_loss", "box_err",
                                                         "teacher_agreement"))
    assert set(report["final"]["int8"]) == {"int8_box_err", "int8_top_box_agreement"}
    assert os.path.isfile(os.path.join(w, "final", "best_converted_detector.msgpack"))
    assert os.path.isfile(os.path.join(w, "REPORT_detect.md"))


# ---------------------------------------------------------------------------
# validate_real and the wrappers
# ---------------------------------------------------------------------------

def test_validate_real_dry_run_and_refusal(tmp_path):
    """``--dry-run``: a synthesized micro ``.pth`` converted strictly, its
    fp32 top-1 over the synthetic test set, both reports, the micro ViT's
    parameter count; without ``--allow-synthetic`` a data directory with no
    real CIFAR-10 is refused (``SystemExit``), with it the same ``.pth``
    converts strictly on the synthetic set."""
    report = validate_real.main(["--workdir", str(tmp_path / "dry"), "--dry-run"],
                                device="cpu")
    assert report["converted_from_torch_strict"] is True
    assert 0.0 <= report["teacher_fp32_top1"] <= 1.0
    micro = create_model(MICRO).module
    assert report["teacher_params"] == sum(p.numel() for p in micro.parameters())
    assert report["teacher_ckpt"].endswith("teacher_dry.pth")
    assert (tmp_path / "dry" / "REPORT_real.md").is_file()
    with pytest.raises(SystemExit) as refused:
        validate_real.main(["--workdir", str(tmp_path / "real"), "--data-dir",
                            str(tmp_path / "empty"), "--teacher-ckpt", "whatever.msgpack"],
                           device="cpu")
    assert refused.value.code == 2
    assert not (tmp_path / "real" / "REPORT_real.json").exists()


def _wrapper_argv(tmp_path, script, args):
    """The argv a wrapper hands ``python``: a stub ``python`` first on
    ``PATH`` writes its arguments, one a line."""
    stub = tmp_path / "bin"
    stub.mkdir(exist_ok=True)
    rec = tmp_path / "argv.txt"
    (stub / "python").write_text(f'#!/bin/sh\nprintf "%s\\n" "$@" > "{rec}"\n')
    (stub / "python").chmod(0o755)
    env = dict(os.environ, PATH=f"{stub}{os.pathsep}{os.environ['PATH']}")
    subprocess.run(["bash", script, *args], check=True, env=env, timeout=30)
    return rec.read_text().splitlines()


@pytest.mark.parametrize("name,args", [
    ("train_final.sh", ["--epochs", "2", "--config", "qat_search/best_params.yaml"]),
    ("search_qat.sh", []),
    ("search_qat.sh", ["5", "3", "out dir"]),
    ("evaluate.sh", []),
    ("evaluate.sh", ["--qat-backend", "fbgemm"]),
    ("evaluate.sh", ["a.msgpack", "--limit-batches", "2"]),
    ("evaluate.sh", ["a.msgpack", "b.msgpack", "--qat-backend", "fbgemm"]),
])
def test_wrappers_exec_the_port_as_jax_execs_its_package(tmp_path, name, args):
    """Each wrapper runs ``python -m`` the port's module with the argv JAX's
    wrapper gives its package's; ``evaluate.sh --qat-backend fbgemm`` keeps
    the flag pair."""
    got = _wrapper_argv(tmp_path, os.path.join(ROOT, "qat_vit_tpu_torch", "scripts", name), args)
    want = _wrapper_argv(tmp_path, os.path.join(ROOT, "scripts", name), args)
    assert got[0] == "-m" and got[1].startswith("qat_vit_tpu_torch.")
    assert got == [want[0], want[1].replace("qat_vit_tpu.", "qat_vit_tpu_torch.", 1)] + want[2:]
    if "fbgemm" in args:
        assert got[-2:] == ["--qat-backend", "fbgemm"]
        assert got[got.index("--qat-ckpt") + 1] != "--qat-backend"


def test_scripts_import_without_jax():
    """Every module of the port's ``scripts`` imports in a child process
    that blocks jax, flax and the JAX package."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'qat_vit_tpu', 'triton'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import qat_vit_tpu_torch.scripts.accuracy_loop, qat_vit_tpu_torch.scripts.detect_loop\n"
        "import qat_vit_tpu_torch.scripts.validate_real, qat_vit_tpu_torch.scripts.convert_teacher\n"
        "import qat_vit_tpu_torch.scripts.pretrain_teacher\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
