"""Port parity for the hyperparameter search (``qat_vit_tpu_torch/search``),
on the CPU, against the JAX package:

- the in-repo TPE (``search/tpe.py``): the port's copy and JAX's give the
  same suggestions, states, values and prune decisions over 20 trials at
  seeds 0-2, univariate and multivariate;
- the two drivers with their trainer classes replaced by one deterministic
  stub (its accuracy a function of the hyperparameters and the epoch, one
  trial raising), on both tasks: the same trial parameters, pruned and
  FAILED trials, tracked runs (names, params, metrics, tags) and
  ``best_params.yaml`` bytes; trial 0 is built without ``teacher_params``,
  every later trial with the shared teacher, steps and teacher cache;
- the port's driver for real on micro models (2 trials x 2 epochs x 2
  batches): trial ``k``'s first student is a fresh trainer's at seed
  ``seed + k``, trial 1 makes no teacher forward for rows that trial 0
  filled, ``best_params.yaml`` reads back through ``load_flat_yaml`` as
  through ``yaml.safe_load``; the CLI; the refusals.

JAX's own driver is never run with its real trainers here (its tests mark
that slow).
"""

import dataclasses
import math
import os
import sqlite3

import numpy as np
import pytest
import torch
import yaml

import qat_vit_tpu.search.driver as jax_driver
import qat_vit_tpu.train.detect_trainer as jax_detect_trainer
from qat_vit_tpu.search import tpe as jax_tpe
from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
from qat_vit_tpu_torch.search import driver as port_driver
from qat_vit_tpu_torch.search import tpe as port_tpe
from qat_vit_tpu_torch.train import detect_trainer as port_detect_trainer
from qat_vit_tpu_torch.train.config import load_flat_yaml
from qat_vit_tpu_torch.train.trainer import KDQATTrainer


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
# TPE
# ---------------------------------------------------------------------------


def _tpe_history(tpe, seed: int, multivariate: bool, n_trials: int = 20):
    """A study over the reference's search space with a deterministic
    objective that reports three steps; returns every trial's record."""
    study = tpe.create_study(direction="maximize", seed=seed, n_startup_trials=5,
                             n_warmup_steps=1, multivariate=multivariate)
    prunes = []

    def objective(trial):
        lr = trial.suggest_float("lr", 5e-5, 3e-4, log=True)
        wd = trial.suggest_float("weight_decay", 1e-6, 1e-2, log=True)
        ls = trial.suggest_float("label_smoothing", 0.0, 0.2)
        t = trial.suggest_float("kd_temperature", 1.5, 6.0)
        a = trial.suggest_float("kd_alpha", 0.2, 0.9)
        q = trial.suggest_int("qat_start_epoch", 0, 3)
        value = 0.0
        for step in range(3):
            value = (0.6 - 0.1 * abs(math.log(lr / 1.5e-4)) - 10.0 * wd - abs(ls - 0.1)
                     - 0.02 * abs(t - 4.0) - 0.1 * abs(a - 0.5) - 0.01 * q + 0.05 * step)
            trial.report(value, step)
            pruned = trial.should_prune()
            prunes.append((trial.number, step, pruned))
            if pruned:
                raise tpe.TrialPruned()
        return value

    study.optimize(objective, n_trials=n_trials)
    trials = [(t.number, dict(t.params), t.value, t.state, dict(t.intermediate))
              for t in study.trials]
    return trials, prunes, study.best_params, study.best_value


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("multivariate", [False, True])
def test_tpe_matches_jax(seed, multivariate):
    """Identical suggestions, values, states and prune decisions (exact
    equality: the same numpy calls in the same order)."""
    got = _tpe_history(port_tpe, seed, multivariate)
    want = _tpe_history(jax_tpe, seed, multivariate)
    assert got == want
    states = {t[3] for t in got[0]}
    assert "COMPLETE" in states


def test_tpe_prunes_somewhere():
    """The comparison above covers prune decisions that fire."""
    fired = [p for seed in (0, 1, 2) for mv in (False, True)
             for _, _, p in _tpe_history(port_tpe, seed, mv)[1] if p]
    assert fired


# ---------------------------------------------------------------------------
# the two drivers around one stub trainer
# ---------------------------------------------------------------------------

STUB_SEED = 3
FAIL_TRIAL = 3


class StubTrainer:
    """Stands in for both packages' trainers (both tasks): accuracy from the
    hyperparameters and the epoch, trial ``FAIL_TRIAL`` raising, and a
    record of what the search driver handed each trial."""

    built = []

    def __init__(self, hp, *, data=None, student=None, teacher=None, teacher_params=None,
                 seed=None, steps=None, teacher_logits=None, teacher_cache=None, device=None,
                 **_):
        self.hp = hp
        self.trial = seed - STUB_SEED
        self.detection = hp.get("task") == "detection"
        self.qat_enabled = False
        self.teacher_params = ("teacher", self.trial)
        self._steps = {"train_float": ("steps", self.trial)}
        n = len(data["train_images"])
        self._teacher_logits = np.zeros((n, 10), np.float32)
        self._teacher_mask = np.zeros(n, bool)
        self._cache = (np.zeros(n), np.zeros(n), np.zeros(n), np.zeros(n, bool))
        StubTrainer.built.append({
            "trial": self.trial, "teacher_params": teacher_params, "steps": steps,
            "teacher_logits": teacher_logits, "teacher_cache": teacher_cache,
            "student_meta": student is not None and any(
                getattr(p, "is_meta", False) for p in getattr(student.module, "parameters",
                                                              lambda: [])())})

    def shared_steps(self):
        return self._steps

    def teacher_cache(self):
        return self._cache

    def enable_qat(self):
        self.qat_enabled = True

    def _acc(self):
        hp = self.hp
        base = 0.6 - 0.1 * abs(math.log(hp["lr"] / 1.5e-4)) - 10.0 * hp["weight_decay"]
        if self.detection:
            base -= 0.05 * abs(math.log(hp["det_box_weight"])) + 0.1 * hp["det_obj_weight"]
        else:
            base -= abs(hp["label_smoothing"] - 0.1) + 0.1 * abs(hp["kd_alpha"] - 0.5)
        return base - 0.02 * abs(hp["kd_temperature"] - 4.0) + 0.05 * self.epoch

    def train_epoch(self, epoch, limit_batches=0):
        if self.trial == FAIL_TRIAL:
            raise RuntimeError(f"stub trial {self.trial} fails")
        self.epoch = epoch
        out = {"train_loss": 1.0 + epoch + self.hp["lr"], "train_loss_kd": 0.25 * epoch}
        if self.detection:
            out.update(train_loss_box=0.5 / (epoch + 1), train_loss_obj=0.125)
        else:
            out["train_loss_ce"] = 0.75 - 0.125 * epoch
        return out

    def evaluate(self, limit_batches=0):
        acc = self._acc()
        if self.detection:
            return {"teacher_agreement": acc, "box_err": 0.5 - acc / 4}
        return acc


def _store(db, experiment):
    """Every run of the store: name, status, params, metrics, tags."""
    with sqlite3.connect(db) as c:
        exp = c.execute("SELECT experiment_id FROM experiments WHERE name=?",
                        (experiment,)).fetchone()[0]
        runs = c.execute("SELECT run_uuid, name, status FROM runs WHERE experiment_id=? "
                         "ORDER BY start_time, rowid", (exp,)).fetchall()
        out = []
        for rid, name, status in runs:
            params = dict(c.execute("SELECT key, value FROM params WHERE run_uuid=?", (rid,)))
            metrics = sorted(c.execute("SELECT key, value, step FROM metrics WHERE run_uuid=?",
                                       (rid,)))
            tags = dict(c.execute("SELECT key, value FROM tags WHERE run_uuid=?", (rid,)))
            tb = tags.pop("failure_traceback", None)
            if tb is not None:  # the paths differ; the exception line does not
                tags["failure_traceback"] = tb.strip().splitlines()[-1]
            out.append((name, status, params, metrics, tags))
    return out


def _run_driver(mod, tmp, task, monkeypatch, **run_kw):
    StubTrainer.built = []
    cfg = mod.SearchConfig(trials=10, epochs=3, micro=True, batch_size=8, eval_batch_size=8,
                           limit_train_batches=1, limit_eval_batches=1, seed=STUB_SEED,
                           output_dir=os.path.join(tmp, "out"),
                           mlflow_uri=f"sqlite:///{tmp}/m.db", task=task)
    data = synthetic_cifar10(n_train=32, n_test=16, seed=0)
    res = mod.run_optuna_search(cfg, data=data, prefer_optuna=False, **run_kw)
    with open(res["best_params_path"], "rb") as f:
        raw = f.read()
    trials = [(t.number, dict(t.params), t.value, t.state, dict(t.intermediate))
              for t in res["study"].trials]
    return trials, _store(f"{tmp}/m.db", cfg.experiment), raw, res, list(StubTrainer.built)


@pytest.mark.parametrize("task", ["classification", "detection"])
def test_driver_matches_jax_with_stub_trainer(task, tmp_path, monkeypatch):
    """One stub behind both drivers: identical trials (params, values,
    states, reports; pruned and FAILED), tracked runs and YAML bytes."""
    monkeypatch.setattr(jax_driver, "KDQATTrainer", StubTrainer)
    monkeypatch.setattr(jax_detect_trainer, "DetectKDTrainer", StubTrainer)
    monkeypatch.setattr(port_driver, "KDQATTrainer", StubTrainer)
    monkeypatch.setattr(port_detect_trainer, "DetectKDTrainer", StubTrainer)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _run_driver(jax_driver, str(tmp_path / "jax"), task, monkeypatch)
    got = _run_driver(port_driver, str(tmp_path / "port"), task, monkeypatch, device="cpu")
    assert got[0] == want[0]
    states = [t[3] for t in got[0]]
    assert states[FAIL_TRIAL] == "FAIL" and "PRUNED" in states and "COMPLETE" in states
    assert got[1] == want[1]
    names = [r[0] for r in got[1]]
    assert names == [f"trial_{i:04d}" for i in range(10)] + ["optuna_best_summary"]
    failed = got[1][FAIL_TRIAL]
    assert failed[1] == "FAILED" and failed[4]["optuna_state"] == "FAILED"
    assert failed[4]["failure_traceback"] == f"RuntimeError: stub trial {FAIL_TRIAL} fails"
    assert got[2] == want[2]
    assert got[2] == yaml.safe_dump(got[3]["best_params"], sort_keys=True).encode()
    assert got[3]["best_params"] == want[3]["best_params"]
    assert got[3]["best_value"] == want[3]["best_value"]
    # what the port handed each trial: trial 0 builds the teacher, every later
    # trial takes trial 0's teacher, steps and teacher cache by reference
    built = got[4]
    assert [b["trial"] for b in built] == list(range(10))
    assert built[0]["teacher_params"] is None and built[0]["steps"] is None
    assert all(b["student_meta"] for b in built)
    cache_key = "teacher_cache" if task == "detection" else "teacher_logits"
    assert built[0][cache_key] is None
    for b in built[1:]:
        assert b["teacher_params"] == ("teacher", 0)
        assert b["steps"] == {"train_float": ("steps", 0)}
        assert b[cache_key] is built[1][cache_key] and b[cache_key] is not None


def test_best_params_yaml_types(tmp_path, monkeypatch):
    """Python ``float`` / ``int`` values only (no numpy scalars), an int
    ``qat_start_epoch``, ``kd_temp`` beside ``kd_temperature``."""
    monkeypatch.setattr(port_driver, "KDQATTrainer", StubTrainer)
    _, _, raw, res, _ = _run_driver(port_driver, str(tmp_path), "classification", monkeypatch,
                                    device="cpu")
    out = res["best_params"]
    assert type(out["qat_start_epoch"]) is int and type(out["epochs"]) is int
    assert all(type(out[k]) is float for k in ("lr", "weight_decay", "kd_temperature"))
    assert out["kd_temp"] == out["kd_temperature"] and out["qat_backend"] == "qnnpack"
    assert yaml.safe_load(raw.decode()) == load_flat_yaml(raw.decode()) == out


# ---------------------------------------------------------------------------
# the port's driver with its real trainers, micro models
# ---------------------------------------------------------------------------


class RecordingTrainer(KDQATTrainer):
    """The port's trainer, recording each trial's first student and the
    rows its teacher forwards fill."""

    log = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        RecordingTrainer.log.append({
            "student": {k: v.clone() for k, v in self.student_float.state_dict().items()},
            "filled": [], "logits": self._teacher_logits, "kw": kw})

    def _teacher_logits_for(self, batch):
        idx = batch["index"]
        RecordingTrainer.log[-1]["filled"].extend(idx[~self._teacher_mask[idx]].tolist())
        RecordingTrainer.log[-1]["logits"] = self._teacher_logits
        return super()._teacher_logits_for(batch)


def test_port_driver_micro_trials(tmp_path, monkeypatch):
    RecordingTrainer.log = []
    monkeypatch.setattr(port_driver, "KDQATTrainer", RecordingTrainer)
    data = synthetic_cifar10(n_train=256, n_test=64, seed=1)
    cfg = port_driver.SearchConfig(trials=2, epochs=2, micro=True, batch_size=16,
                                   eval_batch_size=32, limit_train_batches=2,
                                   limit_eval_batches=2, seed=5,
                                   output_dir=str(tmp_path / "out"),
                                   mlflow_uri=f"sqlite:///{tmp_path}/m.db")
    res = port_driver.run_optuna_search(cfg, data=data, device="cpu")
    assert [t.state for t in res["study"].trials] == ["COMPLETE", "COMPLETE"]
    t0, t1 = RecordingTrainer.log
    # trial k's first student is a fresh trainer's at seed + k (the same
    # teacher and student architecture handed in), and the two differ
    for k, rec in enumerate((t0, t1)):
        fresh = KDQATTrainer(_hp_of(cfg), device="cpu", data=data, student=rec["kw"]["student"],
                             teacher=_micro_teacher(cfg), seed=cfg.seed + k)
        sd = fresh.student_float.state_dict()
        assert sd.keys() == rec["student"].keys()
        assert all(torch.equal(sd[n], rec["student"][n]) for n in sd)
    assert not all(torch.equal(t0["student"][n], t1["student"][n]) for n in t0["student"])
    # the teacher cache: trial 1 shares trial 0's arrays and forwards only
    # rows trial 0 never filled
    assert t1["kw"]["teacher_params"] is t0["kw"]["teacher"].module
    assert t1["logits"] is t0["logits"]
    assert t0["filled"] and not set(t0["filled"]) & set(t1["filled"])
    text = open(res["best_params_path"]).read()
    assert load_flat_yaml(text) == yaml.safe_load(text) == res["best_params"]


def _micro_teacher(cfg):
    from qat_vit_tpu_torch.models.registry import create_model

    return create_model("vit_micro_test", generator=torch.Generator().manual_seed(cfg.seed))


def _hp_of(cfg):
    from qat_vit_tpu_torch.train.config import DEFAULT_HPARAMS

    hp = dict(DEFAULT_HPARAMS)
    hp.update(epochs=cfg.epochs, batch_size=cfg.batch_size, eval_batch_size=cfg.eval_batch_size,
              image_size=32, num_classes=10, seed=cfg.seed)
    return hp


def test_search_cli_and_refusals(tmp_path, monkeypatch):
    """``main(argv, device="cpu")`` with JAX's flags on a micro search (data
    from a small ``cifar10.npz``); no CUDA device and an unknown flag
    refused; ``model_parallel`` reaches the trainer (JAX's
    ``search/driver.py``), which in a world of one refuses 2 with JAX's
    mesh error: the trial fails, and no trial completes."""
    d = synthetic_cifar10(n_train=64, n_test=32, seed=2)
    (tmp_path / "data").mkdir()
    np.savez(tmp_path / "data" / "cifar10.npz", **d)
    out = tmp_path / "out"
    port_driver.main(["--trials", "1", "--epochs", "2", "--micro", "--batch-size", "16",
                      "--eval-batch-size", "16", "--limit-train-batches", "1",
                      "--limit-eval-batches", "1", "--output-dir", str(out), "--mlflow-uri",
                      f"sqlite:///{tmp_path}/m.db", "--data-dir", str(tmp_path / "data"),
                      "--tpe-multivariate"], device="cpu")
    best = load_flat_yaml((out / "best_params.yaml").read_text())
    assert best["epochs"] == 2 and best["batch_size"] == 16 and "kd_temp" in best
    cfg = port_driver.SearchConfig(micro=True, output_dir=str(tmp_path / "x"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_driver.run_optuna_search(cfg)
    seen = []

    def trainer(hp, **kw):
        seen.append(hp["model_parallel"])
        try:
            return KDQATTrainer(hp, **kw)
        except ValueError as e:
            seen.append(str(e))
            raise

    monkeypatch.setattr(port_driver, "KDQATTrainer", trainer)
    with pytest.raises(ValueError, match="no completed trials"):
        port_driver.run_optuna_search(
            port_driver.SearchConfig(micro=True, model_parallel=2, trials=1,
                                     output_dir=str(tmp_path / "y"),
                                     mlflow_uri=f"sqlite:///{tmp_path}/y.db"),
            data=synthetic_cifar10(n_train=16, n_test=8, seed=2), prefer_optuna=False,
            device="cpu")
    assert seen == [2, "1 devices not divisible by model=2"]
    assert [f.name for f in dataclasses.fields(port_driver.SearchConfig)] == [
        f.name for f in dataclasses.fields(jax_driver.SearchConfig)]
    assert port_driver.SearchConfig().__dict__ == jax_driver.SearchConfig().__dict__
