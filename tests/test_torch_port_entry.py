"""Port parity for the training entry points and their host-side modules, on
the CPU, against the JAX package:

- the flat-YAML writer and reader (``train/config.py``) against
  ``yaml.safe_dump(sort_keys=True)`` / ``yaml.safe_load`` and JAX's
  ``save_effective_hparams``, byte for byte, on the defaults, a
  ``hypothesis`` sweep per value type and the edge cases; the CLI flags
  (``add_hparam_flags`` / ``resolve_hparams``) over ``tests/test_config.py``'s
  cases;
- the trackers (each package's SQLite store read by the other, the two
  reports equal), the system-metrics sampler, the profiler trace and
  ``StepTimer``;
- the native data plane (``data/native_loader.py``) and ``ArrayLoader``
  against JAX's, with the native path on and off;
- the rank helpers of one process and the progress bar;
- ``observer_interval`` in the trainer; ``train_main`` on micro models
  (artifacts read by the JAX package against JAX-built templates, the
  tracker's keys, resume), the CLI's ``--task detection`` route, and the
  entry points refusing to run without a CUDA device.
"""

import argparse
import itertools
import json
import math
import os
import time

import numpy as np
import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import flax.linen as nn
import jax

from qat_vit_tpu.train import config as jax_config
from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
from qat_vit_tpu_torch.models.registry import create_model
from qat_vit_tpu_torch.train import config
from qat_vit_tpu_torch.train import trainer as tr


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
# flat YAML and the CLI flags
# ---------------------------------------------------------------------------

EDGE_STRINGS = ["", "yes", "No", "on", "1.5", "1e5", "null", "~", "a: b", "a:b", "- x", "-",
                "-x", "?", "#x", "a #b", "a#b", "2001-01-01", "=", "<<", " lead", "trail ",
                "it's", "'q'", "---", "...x", "0x1F", "012", "1_000", "1:30", ".inf", "@x",
                "sqlite:///mlflow.db", "./data", ("word " * 40).strip(), "x" * 100,
                ("'q' " * 40).strip()]
EDGE_FLOATS = [1e-08, 1e20, 1e16, math.inf, -math.inf, -0.0, 0.0, math.nan, 1.5e-4, 3.3e-4,
               5e-324, 1.7976931348623157e308, 123456789.125]


def _same(a, b) -> bool:
    """Equal values of equal type; NaN equal to NaN; -0.0 apart from 0.0."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a):
            return math.isnan(b)
        return a == b and math.copysign(1.0, a) == math.copysign(1.0, b)
    return type(a) is type(b) and a == b


def _value_strategy(t):
    if t is bool:
        return st.booleans()
    if t is int:
        return st.integers(-2 ** 70, 2 ** 70)
    if t is float:
        return st.floats() | st.sampled_from(EDGE_FLOATS)
    return (st.text(st.characters(min_codepoint=32, max_codepoint=126), max_size=200)
            | st.sampled_from(EDGE_STRINGS))


@pytest.mark.parametrize("defaults", ["port", "jax"])
def test_effective_hparams_bytes_match_jax(tmp_path, defaults):
    """``save_effective_hparams`` writes the bytes of JAX's (``yaml.safe_dump``)
    for both packages' defaults, and the file reads back as ``yaml.safe_load``
    reads it."""
    hp = dict(config.DEFAULT_HPARAMS if defaults == "port" else jax_config.DEFAULT_HPARAMS)
    hp["lr"] = 3.3e-4
    want = yaml.safe_dump(hp, sort_keys=True)
    assert config.dump_flat_yaml(hp) == want
    ours = config.save_effective_hparams(hp, str(tmp_path / "port"))
    theirs = jax_config.save_effective_hparams(hp, str(tmp_path / "jax"))
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert _same(config.load_flat_yaml(want), yaml.safe_load(want)) and _same(
        config.load_flat_yaml(want), hp)


@settings(max_examples=150, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(hp=st.fixed_dictionaries({k: _value_strategy(type(v))
                                 for k, v in config.DEFAULT_HPARAMS.items()}))
def test_flat_yaml_sweep_matches_pyyaml(hp):
    """A sweep of every key's type (printable-ASCII strings to 200
    characters, so long values fold past column 80; any float; ints past
    64 bits): the writer's bytes are PyYAML's, the reader returns what
    ``yaml.safe_load`` returns."""
    want = yaml.safe_dump(hp, sort_keys=True)
    got = config.dump_flat_yaml(hp)
    assert got == want
    assert _same(config.load_flat_yaml(got), yaml.safe_load(want))


@pytest.mark.parametrize("value", EDGE_STRINGS + EDGE_FLOATS + [True, False, 0, -1, None],
                         ids=lambda v: repr(v)[:24])
def test_flat_yaml_edge_cases(value):
    """Each edge case alone as the value and, for strings, as a key:
    ``1.0e-08``, ``.inf``, ``-0.0``, ``''``, the strings that would read back
    as another type (``'yes'``, ``'1.5'``, ``'null'``, ``'a: b'``, ...),
    folded long strings; the bytes are PyYAML's and read back."""
    maps = [{"resume": value}]
    if isinstance(value, str) and 0 < len(value) < 123:  # longer keys: "? key" lines
        maps.append({value: 1, "a": value})
    for m in maps:
        want = yaml.safe_dump(m, sort_keys=True)
        assert config.dump_flat_yaml(m) == want
        assert _same(config.load_flat_yaml(want), yaml.safe_load(want))


def test_flat_yaml_reader_comments_and_best_params(tmp_path):
    """Comments and blank lines are dropped; a search's ``best_params.yaml``
    (``yaml.safe_dump`` of a flat mapping) and a hand-written one read as
    PyYAML reads them, and ``load_hparams`` gives JAX's result on both."""
    hand = ("# best trial of the search\n\nlr: 6.53e-05  # trial 7\nkd_temp: 4.43\n"
            "qat_backend: 'qnnpack'\n   \namp: 'false'\nepochs: 10\n# end\n")
    search = yaml.safe_dump({"lr": 6.53e-5, "weight_decay": 1.72e-5, "label_smoothing": 0.048,
                             "kd_temperature": 4.43, "kd_alpha": 0.615, "qat_start_epoch": 0,
                             "epochs": 10, "batch_size": 64, "qat_backend": "qnnpack"})
    for i, text in enumerate((hand, search)):
        assert _same(config.load_flat_yaml(text), yaml.safe_load(text))
        path = tmp_path / f"best_params_{i}.yaml"
        path.write_text(text)
        got = config.load_hparams(str(path))
        want = jax_config.load_hparams(str(path))
        assert _same({k: got[k] for k in want}, want)
    assert config.load_flat_yaml("") is None and config.load_flat_yaml("{}\n") == {}
    assert config.load_flat_yaml("# only a comment\n") is None


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb:\n  c: 2\n", 2),  # nesting
    ("a: {b: 1}\n", 1),  # flow mapping
    ("a: [1, 2]\n", 1),  # flow sequence
    ("a: &x 1\nb: *x\n", 1),  # anchor and alias
    ("a: !!str 1\n", 1),  # tag
    ('a: "x"\n', 1),  # double quotes
    ("- 1\n- 2\n", 1),  # a sequence
    ("a:\n- 1\n", 2),
    ("a: |\n  text\n", 1),  # block scalar
    ("a: 1\na: 2\n", 2),  # repeated key
    ("a: 2001-01-01\n", 1),  # timestamp
    ("---\na: 1\n", 1),  # document marker
    ("  a: 1\n", 1),  # indented mapping
])
def test_flat_yaml_reader_refuses(text, line):
    """Anything but a flat mapping of scalars raises a ValueError naming its
    line."""
    with pytest.raises(ValueError, match=f"line {line}"):
        config.load_flat_yaml(text)


def _config_cases(tmp_path):
    """``tests/test_config.py``'s cases as (argv, overlay written first)."""
    best = {"lr": 6.53e-5, "weight_decay": 1.72e-5, "label_smoothing": 0.048,
            "kd_temperature": 4.43, "kd_alpha": 0.615, "qat_start_epoch": 0, "epochs": 10,
            "batch_size": 64, "qat_backend": "qnnpack"}
    overlays = [None, {"lr": 6.53e-5, "qat_start_epoch": 0}, {"lr": 1e-4, "epochs": 20},
                {"kd_temp": 4.43, "lr": 6.53e-5},
                {"lr": "0.0001", "qat_start_epoch": "3", "amp": "false"}, best]
    cases = [([], None), (["--amp", "false"], None), (["--amp", "true"], None),
             (["--config", str(tmp_path / "nope.yaml")], None),
             (["--lr", "2e-4", "--task", "detection", "--observer-interval", "4"], None)]
    for i, overlay in enumerate(overlays[1:], 1):
        path = tmp_path / f"c{i}.yaml"
        path.write_text(yaml.safe_dump(overlay))
        cases.append((["--config", str(path)], overlay))
    cases.append((["--config", str(tmp_path / "c2.yaml"), "--lr", "2e-4"], overlays[2]))
    return cases


def test_resolve_hparams_matches_jax(tmp_path):
    """``resolve_hparams(parser.parse_args(argv))`` with the port's
    ``add_hparam_flags`` equals JAX's over ``tests/test_config.py``'s cases;
    the port's only key beyond JAX's is ``query_seed`` (the detection
    queries' seed, which the JAX detection trainer reads with the same
    default)."""
    assert set(config.DEFAULT_HPARAMS) - set(jax_config.DEFAULT_HPARAMS) == {"query_seed"}
    assert {k: v for k, v in config.DEFAULT_HPARAMS.items() if k != "query_seed"} == \
        jax_config.DEFAULT_HPARAMS
    for argv, _ in _config_cases(tmp_path):
        parsers = []
        for mod in (config, jax_config):
            p = argparse.ArgumentParser()
            mod.add_hparam_flags(p)
            parsers.append(mod.resolve_hparams(p.parse_args(argv)))
        got, want = parsers
        assert got.pop("query_seed") == -1
        assert _same(got, want), argv


# ---------------------------------------------------------------------------
# tracking, system metrics, profiling
# ---------------------------------------------------------------------------

def _log_run(mod, uri, artifact):
    t = mod.SqliteTracker(uri, "exp")
    run = t.start_run("final_train")
    run.log_params({"lr": 1e-3, "epochs": 2, "amp": True})
    run.log_metrics({"train_loss": 1.5, "qat_acc": 0.25}, step=0)
    run.log_metrics({"train_loss": 1.25, "qat_acc": 0.5}, step=1)
    run.log_metric("final_quant_acc", 0.5)
    run.set_tag("data_source", "synthetic")
    run.log_artifact(artifact)
    run.end("FINISHED")
    with pytest.raises(RuntimeError), mod.SqliteTracker(uri, "exp").start_run("failed") as bad:
        bad.log_metric("val_acc_limited", 0.125, step=3)
        raise RuntimeError("the trial failed")
    return run.run_id


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trackers_read_each_other(tmp_path, writer):
    """Each package's SQLite store reads the other's runs, params, metrics,
    tags, artifacts and status; the two ``summarize`` give equal dicts."""
    from qat_vit_tpu.tracking import report as jax_report
    from qat_vit_tpu.tracking import tracker as jax_tracker
    from qat_vit_tpu_torch.tracking import report, tracker

    w, r = (tracker, jax_tracker) if writer == "port" else (jax_tracker, tracker)
    uri = f"sqlite:///{tmp_path}/mlflow.db"
    artifact = tmp_path / "effective_hparams.yaml"
    artifact.write_text("lr: 0.001\n")
    run_id = _log_run(w, uri, str(artifact))
    store = r.SqliteTracker(uri, "exp", create=False)
    runs = {x["name"]: x for x in store.runs()}
    assert runs["final_train"] == {"run_id": run_id, "name": "final_train", "status": "FINISHED"}
    assert runs["failed"]["status"] == "FAILED"
    assert store.params(run_id) == {"lr": "0.001", "epochs": "2", "amp": "True"}
    got = sorted((m["key"], m["step"], m["value"]) for m in store.metrics(run_id))
    assert got == [("final_quant_acc", 0, 0.5), ("qat_acc", 0, 0.25), ("qat_acc", 1, 0.5),
                   ("train_loss", 0, 1.5), ("train_loss", 1, 1.25)]
    assert store.metrics(run_id, "qat_acc")[1]["value"] == 0.5
    with store._conn() as c:
        assert c.execute("SELECT key, value FROM tags WHERE run_uuid=?",
                         (run_id,)).fetchall() == [("data_source", "synthetic")]
    assert os.listdir(os.path.join(store.artifact_root, run_id)) == ["effective_hparams.yaml"]
    summary = report.summarize(uri, "exp")
    assert summary == jax_report.summarize(uri, "exp")
    assert summary["best_val_acc_limited_overall"] == 0.125
    assert report.format_report(summary) == jax_report.format_report(summary)
    with pytest.raises(KeyError, match="known"):
        r.SqliteTracker(uri, "missing", create=False)


def test_system_metrics_trace_and_step_timer(tmp_path, capsys):
    """The sampler logs host CPU and memory at a short interval (no device
    metric on the CPU); ``trace`` writes a Chrome trace naming the ops it
    saw; ``StepTimer`` discards its warm-up steps; the report's CLI prints."""
    from qat_vit_tpu_torch.tracking import SqliteTracker, SystemMetricsLogger
    from qat_vit_tpu_torch.tracking.report import main as report_main
    from qat_vit_tpu_torch.utils.profiling import StepTimer, trace

    uri = f"sqlite:///{tmp_path}/m.db"
    t = SqliteTracker(uri, "exp")
    run = t.start_run("sys")
    with SystemMetricsLogger(run, interval=0.05, device="cpu"):
        time.sleep(0.4)
    keys = {m["key"] for m in t.metrics(run.run_id)}
    assert keys == {"system/cpu_utilization_percentage", "system/system_memory_usage_megabytes"}
    cpu = [m["value"] for m in t.metrics(run.run_id, "system/cpu_utilization_percentage")]
    assert len(cpu) >= 2 and all(0.0 <= v <= 100.0 for v in cpu)

    with trace(str(tmp_path / "prof"), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(tmp_path / "prof") if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    events = json.load(open(tmp_path / "prof" / files[0]))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)

    timer = StepTimer(warmup=2)
    for _ in range(5):
        with timer:
            time.sleep(0.002)
    assert len(timer.times) == 3 and timer.mean >= 0.002 and timer.p50 >= 0.002
    assert timer.imgs_per_sec(32) == pytest.approx(32 / timer.mean)
    assert math.isnan(StepTimer().mean) and StepTimer().imgs_per_sec(8) == 0.0
    report_main([uri, "exp"])
    assert "experiment: exp  runs: 1" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the native data plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
def test_native_loader_matches_jax(monkeypatch, tmp_path, native):
    """``decode_cifar_bin``, ``gather_batch``, ``shuffle_indices`` and
    ``ArrayLoader``'s batches identical to the JAX package's, with the
    native library and without it (both packages on numpy); ``load_cifar10``
    of a ``.bin`` directory too."""
    from qat_vit_tpu.data import cifar10 as jax_cifar10
    from qat_vit_tpu.data import native_loader as jnl
    from qat_vit_tpu.data.pipeline import ArrayLoader as JaxLoader
    from qat_vit_tpu_torch.data import native_loader as nl
    from qat_vit_tpu_torch.data.cifar10 import load_cifar10
    from qat_vit_tpu_torch.data.pipeline import ArrayLoader

    if native:
        assert nl.native_available() and jnl.native_available()
    else:
        monkeypatch.setattr(nl, "load_native", lambda: None)
        monkeypatch.setattr(jnl, "load_native", lambda: None)
    calls = (nl.decode_cifar_bin.native_calls, nl.gather_batch.native_calls)
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, 7 * 3073, dtype=np.uint8)
    for a, b in zip(nl.decode_cifar_bin(raw), jnl.decode_cifar_bin(raw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    images = rng.integers(0, 256, (50, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 50).astype(np.int32)
    idx = rng.permutation(50)[:13]
    for a, b in zip(nl.gather_batch(images, labels, idx), jnl.gather_batch(images, labels, idx)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(nl.shuffle_indices(100, 7), jnl.shuffle_indices(100, 7))
    for shuffle, drop_last in ((True, True), (False, False)):
        ours = ArrayLoader(images, labels, batch_size=8, shuffle=shuffle, seed=3,
                           drop_last=drop_last)
        theirs = JaxLoader(images, labels, batch_size=8, shuffle=shuffle, seed=3,
                           drop_last=drop_last)
        ours.set_epoch(2)
        theirs.set_epoch(2)
        assert len(ours) == len(theirs)
        for a, b in itertools.zip_longest(ours, theirs):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    bins = tmp_path / "cifar-10-batches-bin"
    bins.mkdir()
    for i, name in enumerate([f"data_batch_{j}.bin" for j in range(1, 6)] + ["test_batch.bin"]):
        rng.integers(0, 256, 3 * 3073, dtype=np.uint8).tofile(bins / name)
    (ours, src), (theirs, jsrc) = load_cifar10(str(tmp_path)), jax_cifar10.load_cifar10(
        str(tmp_path))
    assert src == jsrc == "bin" and ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    decoded = nl.decode_cifar_bin.native_calls - calls[0]
    gathered = nl.gather_batch.native_calls - calls[1]
    if native:
        assert decoded == 7 and gathered >= 5
    else:
        assert decoded == gathered == 0


# ---------------------------------------------------------------------------
# the trainer and the entry points
# ---------------------------------------------------------------------------

def _micro(monkeypatch, n_train=128, n_test=64):
    """The trainer module's models and data, micro: a vit_micro_test student
    and teacher from fixed seeds, synthetic CIFAR-10 of ``n_train`` /
    ``n_test`` images tagged ``synthetic``."""
    data = synthetic_cifar10(n_train=n_train, n_test=n_test, seed=1)
    monkeypatch.setattr(tr, "create_student", lambda *a, **k: create_model(
        "vit_micro_test", qat_wrapper=True, generator=torch.Generator().manual_seed(0)))
    monkeypatch.setattr(tr, "create_teacher", lambda *a, **k: create_model(
        "vit_micro_test", generator=torch.Generator().manual_seed(1)))
    monkeypatch.setattr(tr, "load_cifar10", lambda *a, **k: (data, "synthetic"))
    return data


def _hp(tmp_path, **over):
    hp = dict(config.DEFAULT_HPARAMS)
    hp.update(lr=3e-3, weight_decay=1e-4, epochs=2, qat_start_epoch=1, batch_size=16,
              eval_batch_size=32, image_size=32, output_dir=str(tmp_path / "out"),
              mlflow_uri=f"sqlite:///{tmp_path}/mlflow.db", data_dir=str(tmp_path / "nodata"),
              limit_train_batches=2, limit_eval_batches=1)
    hp.update(over)
    return hp


def test_observer_interval_freezes_stats_between_updates(monkeypatch, tmp_path):
    """The port twin of JAX's test: at ``observer_interval`` 2, after 2 QAT
    steps the statistics equal a 1-step every-step run's (step 2 ran
    frozen), while the optimizer took both steps."""
    _micro(monkeypatch)
    t_a = tr.KDQATTrainer(_hp(tmp_path, observer_interval=2), device="cpu")
    t_a.enable_qat()
    t_a.train_epoch(0, limit_batches=2)
    assert t_a.state.step == 2 and t_a._qat_py_step == 2
    t_b = tr.KDQATTrainer(_hp(tmp_path), device="cpu")
    t_b.enable_qat()
    t_b.train_epoch(0, limit_batches=1)
    stats = {k: v for k, v in t_b.student_qat.state_dict().items() if k.endswith("_val")}
    got = t_a.student_qat.state_dict()
    assert len(stats) == 52 and all(torch.isfinite(v) for v in stats.values())
    for k, v in stats.items():
        assert torch.equal(got[k], v), k


def test_rank_helpers_and_progress_bar(monkeypatch):
    """One process: rank 0 of 1, ``barrier`` free; in an initialized world
    of 2 (the process group stood in for) this is rank 1 of 2, not the main
    process, and ``barrier`` waits in ``dist.barrier`` (gloo: no device
    ids). ``progress_bar`` wraps the loader in tqdm (imported only then)
    with the epoch's total."""
    import sys
    import types

    import torch.distributed as dist

    from qat_vit_tpu_torch.parallel import barrier, get_dist_info, is_main_process

    info = get_dist_info()
    assert (info.rank, info.world_size, info.is_main_process) == (0, 1, True)
    assert is_main_process() and barrier("epoch") is None
    loader = [1, 2, 3]
    assert tr.progress(loader, {"progress_bar": False}, info, 0, 0) is loader
    bars = []
    fake = types.ModuleType("tqdm")
    fake.tqdm = lambda it, **kw: bars.append(kw) or it
    monkeypatch.setitem(sys.modules, "tqdm", fake)
    assert tr.progress(loader, {"progress_bar": True}, info, 3, 2) is loader
    assert tr.progress(loader, {"progress_bar": True}, info, 4, 0) is loader
    assert bars == [{"total": 2, "desc": "epoch 3", "leave": False},
                    {"total": 3, "desc": "epoch 4", "leave": False}]
    waited = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    monkeypatch.setattr(dist, "barrier", lambda **kw: waited.append(kw))
    info = get_dist_info()
    assert (info.rank, info.world_size, info.is_main_process) == (1, 2, False)
    assert info.global_device_count == 2 and not is_main_process()
    assert barrier("epoch") is None and waited == [{}]


def _spec(tree, prefix=""):
    """{path: (shape, dtype)} of a tree's leaves (flax's state dict of it)."""
    from flax import serialization

    tree = serialization.to_state_dict(tree)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_spec(v, f"{prefix}/{k}"))
        else:
            a = np.asarray(v)
            out[f"{prefix}/{k}"] = (a.shape, a.dtype)
    return out


@pytest.fixture(scope="module")
def jax_templates():
    """JAX-built trees of the micro run's files: params and observers of a
    vit_micro_test, its ``convert_vit`` export, a JAX trainer's resume tree
    under QAT."""
    from qat_vit_tpu.models.registry import create_model as jax_create_model
    from qat_vit_tpu.parallel import make_mesh
    from qat_vit_tpu.serve.int8_vit import convert_vit as jax_convert_vit
    from qat_vit_tpu.train import steps as jax_steps
    from qat_vit_tpu.train.trainer import KDQATTrainer as JaxTrainer

    jm = jax_create_model("vit_micro_test", qat_wrapper=True)
    params = jax.device_get(nn.meta.unbox(jm.module.init(
        jax.random.key(0), jm.example_input(1), observe=False))["params"])
    stats = jax.device_get(jax_steps.init_quant_stats(jm.module, jm.cfg))
    stats = jax.tree.map(lambda v: np.zeros_like(v), stats)
    jt = JaxTrainer(_hp_plain(), data=synthetic_cifar10(n_train=16, n_test=8),
                    mesh=make_mesh(data=1, devices=jax.devices()[:1]),
                    student=jm, teacher=jax_create_model("vit_micro_test"))
    jt.enable_qat()
    resume = {"params": jt.state.params, "opt_state": jt.state.opt_state,
              "quant_stats": jt.state.quant_stats, "step": 0, "epoch": 0, "qat_enabled": 0}
    return {"best_qat": {"params": params, "quant_stats": stats},
            "best_qat_float": {"params": params, "quant_stats": {}},
            "best_converted": jax_convert_vit(params, stats, jm.cfg),
            "resume_state": jax.device_get(resume)}


def _hp_plain():
    hp = dict(jax_config.DEFAULT_HPARAMS)
    hp.update(batch_size=8, eval_batch_size=8, image_size=32, epochs=1)
    return hp


def test_train_main_artifacts(monkeypatch, tmp_path, jax_templates):
    """``train_main`` on micro models (``device="cpu"``): JAX's artifact set;
    ``effective_hparams.yaml`` equal to JAX's writer's bytes; every msgpack
    read by the JAX package's ``load_checkpoint`` against a JAX-built
    template, with keys, shapes and dtypes equal to it; the tracker's run,
    params, tag and metric names; the profiled QAT epoch's trace; then a
    resumed run (``--resume``, one more epoch) that trains epoch 2 only."""
    from qat_vit_tpu.tracking import SqliteTracker as JaxTracker
    from qat_vit_tpu.utils import checkpoint as jck

    _micro(monkeypatch)
    hp = _hp(tmp_path, profile_dir=str(tmp_path / "prof"), observer_interval=2)
    result = tr.train_main(hp, device="cpu")
    out = hp["output_dir"]
    want = {"effective_hparams.yaml", "best_qat.msgpack", "best_qat.msgpack.json",
            "best_converted.msgpack", "best_converted.msgpack.json", "resume_state.msgpack",
            "resume_state.msgpack.json"}
    assert want <= set(os.listdir(out))
    assert [r.epoch for r in result["results"]] == [0, 1] and result["results"][1].qat_enabled
    jax_config.save_effective_hparams(hp, str(tmp_path / "jax"))
    assert (open(os.path.join(out, "effective_hparams.yaml"), "rb").read()
            == open(tmp_path / "jax" / "effective_hparams.yaml", "rb").read())
    meta = jck.load_metadata(os.path.join(out, "best_converted.msgpack"))
    assert meta["format"] == "int8-weights+qparams" and meta["epoch"] == 1
    best_meta = jck.load_metadata(os.path.join(out, "best_qat.msgpack"))
    for name, template in (("best_qat", "best_qat" if best_meta["qat_enabled"]
                            else "best_qat_float"),
                           ("best_converted", "best_converted"),
                           ("resume_state", "resume_state")):
        tmpl = jax_templates[template]
        restored = jck.load_checkpoint(os.path.join(out, f"{name}.msgpack"), tmpl)
        assert _spec(restored) == _spec(tmpl), name
    resume = jck.load_checkpoint(os.path.join(out, "resume_state.msgpack"))
    assert int(resume["epoch"]) == 1 and int(resume["qat_enabled"]) == 1
    assert int(resume["step"]) == 4 and int(resume["opt_state"]["1"]["count"]) == 2
    assert os.listdir(tmp_path / "prof")[0].endswith(".pt.trace.json")

    store = JaxTracker(hp["mlflow_uri"], hp["experiment"])
    (run,) = store.runs()
    assert run["status"] == "FINISHED" and run["name"] == "final_train"
    assert set(store.params(run["run_id"])) == set(config.DEFAULT_HPARAMS)
    keys = {m["key"] for m in store.metrics(run["run_id"])}
    assert {"train_loss", "train_loss_ce", "train_loss_kd", "qat_acc", "quant_acc",
            "imgs_per_sec", "qat_enabled", "final_quant_acc"} <= keys
    with store._conn() as c:
        assert c.execute("SELECT value FROM tags WHERE run_uuid=? AND key='data_source'",
                         (run["run_id"],)).fetchone() == ("synthetic",)
    assert sorted(os.listdir(os.path.join(store.artifact_root, run["run_id"]))) == [
        "best_converted.msgpack", "best_qat.msgpack", "effective_hparams.yaml"]

    again = tr.train_main(dict(hp, resume=os.path.join(out, "resume_state.msgpack"), epochs=3,
                               profile_dir=""), device="cpu")
    assert [r.epoch for r in again["results"]] == [2]
    runs = [r for r in store.runs() if r["run_id"] != run["run_id"]]
    assert {m["step"] for m in store.metrics(runs[0]["run_id"], "train_loss")} == {2}


def test_main_routes_detection(monkeypatch, tmp_path):
    """``main([... "--task", "detection"], device="cpu")`` runs
    ``detect_train_main`` (a micro detector): its artifacts, the int8
    metrics logged at the end, a finished run; without ``--task`` it runs
    ``train_main``."""
    from qat_vit_tpu.utils import checkpoint as jck
    from qat_vit_tpu_torch.tracking import SqliteTracker
    from qat_vit_tpu_torch.train import detect_trainer as dt

    geo = dict(patch_size=8, embed_dim=48, depth=2, num_heads=3, mlp_ratio=2.0)
    real = dt.create_model
    monkeypatch.setattr(dt, "create_model", lambda name, **kw: real(name, **{**kw, **geo}))
    monkeypatch.setattr(dt, "load_cifar10", lambda *a, **k: (
        synthetic_cifar10(n_train=16, n_test=8), "synthetic"))
    out = tmp_path / "det"
    uri = f"sqlite:///{tmp_path}/det.db"
    tr.main(["--task", "detection", "--image-size", "32", "--batch-size", "4",
             "--eval-batch-size", "4", "--epochs", "2", "--qat-start-epoch", "1",
             "--limit-train-batches", "1", "--limit-eval-batches", "1", "--num-queries", "2",
             "--text-dim", "64", "--output-dir", str(out), "--mlflow-uri", uri], device="cpu")
    assert {"effective_hparams.yaml", "best_qat_detector.msgpack", "resume_state.msgpack",
            "best_converted_detector.msgpack"} <= set(os.listdir(out))
    meta = jck.load_metadata(str(out / "best_converted_detector.msgpack"))
    assert meta["format"] == "int8-tower+float-heads" and "int8_top_box_agreement" in meta
    export = jck.load_checkpoint(str(out / "best_converted_detector.msgpack"))
    assert {"tower", "heads"} <= set(export)
    store = SqliteTracker(uri, config.DEFAULT_HPARAMS["experiment"])
    (run,) = store.runs()
    assert run["status"] == "FINISHED" and run["name"] == "final_train_detection"
    keys = {m["key"] for m in store.metrics(run["run_id"])}
    assert {"train_loss_box", "teacher_agreement", "int8_box_err",
            "int8_top_box_agreement"} <= keys
    called = []
    monkeypatch.setattr(tr, "train_main", lambda hp, device: called.append((hp["task"], device)))
    tr.main(["--epochs", "1"], device="cpu")
    assert called == [("classification", "cpu")]


def test_entry_points_need_cuda(monkeypatch, tmp_path):
    """Without a CUDA device the entry points refuse the default device and
    name ``device='cpu'``: no falling back to the CPU."""
    from qat_vit_tpu_torch.train.detect_trainer import detect_train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (tr.train_main, detect_train_main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(_hp(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.main(["--output-dir", str(tmp_path / "x")])
    assert not os.path.exists(tmp_path / "out") and not os.path.exists(tmp_path / "x")
