"""Port parity: ``train_main`` under two gloo ranks on the CPU against one
process at twice the batch (micro models, synthetic data).

Each rank takes ``batch_size`` B of its shard ``rank::2`` of the same
seeded shuffle, so the two ranks' first global batch holds the one-process
run's first batch at 2B: ``perm[0::2][:B] | perm[1::2][:B] == perm[:2B]``.
Both ranks run in ONE spawn (``parallel/dryrun.py``'s worker): two epochs
(QAT from epoch 1, the int8 export at the last), then ``resume`` from rank
0's resume file with one more epoch. Held: both ranks exit 0 within the
spawn's time limit; both report the same epoch metrics, within f32
tolerance of the one-process run; rank 0 alone writes the artifact set;
the resume file reads in the JAX package's ``load_checkpoint`` against a
JAX-built template, and no ``module.`` prefix from DDP reaches any file;
the resumed run trains epoch 2 only. The steps are f32 (``amp`` and
``qat_amp`` off), so the two runs differ by f32 summation order only.
"""

import os

import numpy as np
import pytest
import torch

import jax

from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
from qat_vit_tpu_torch.parallel import dryrun
from qat_vit_tpu_torch.train import trainer as tr
from qat_vit_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_port_entry import _spec, jax_templates  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, N_TRAIN, N_TEST = 4, 64, 37
ARTIFACTS = {"effective_hparams.yaml", "best_qat.msgpack", "best_qat.msgpack.json",
             "best_converted.msgpack", "best_converted.msgpack.json", "resume_state.msgpack",
             "resume_state.msgpack.json"}
# epoch metrics that every rank reports alike (img/s is each rank's own clock)
SHARED = ("train_loss", "qat_acc", "quant_acc", "qat_enabled", "eval_batches")


def _hp(tmp_path, out, db, **over):
    hp = dict(epochs=2, qat_start_epoch=1, batch_size=B, eval_batch_size=8,
              limit_train_batches=2, limit_eval_batches=0, output_dir=str(tmp_path / out),
              mlflow_uri=f"sqlite:///{tmp_path}/{db}.db", data_dir=str(tmp_path / "nodata"))
    hp.update(over)
    return dryrun.micro_trainer_hp(**hp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank runs (first, then resumed) in one spawn, and the
    one-process run at batch 2B."""
    tmp = tmp_path_factory.mktemp("dp_entry")
    hp = _hp(tmp, "out{rank}", "mlflow_dp")
    resume = dict(hp, epochs=3, resume=str(tmp / "out0" / "resume_state.msgpack"))
    job = {"device": "cpu", "out": str(tmp / "job"), "timeout_s": 120, "tasks": [
        {"kind": "train_main", "name": "first", "hp": hp, "n_train": N_TRAIN, "n_test": N_TEST},
        {"kind": "train_main", "name": "resumed", "hp": resume, "n_train": N_TRAIN,
         "n_test": N_TEST}]}
    ranks = dryrun.run_ranks(job, 2, timeout_s=150)
    data = synthetic_cifar10(n_train=N_TRAIN, n_test=N_TEST, seed=1)
    one = tr.train_main(_hp(tmp, "one", "mlflow_one", batch_size=2 * B), device="cpu", data=data,
                        student=dryrun.micro_vit(True), teacher=dryrun.micro_vit(False, seed=1))
    return {"tmp": tmp, "ranks": ranks, "one": one}


def test_ranks_report_the_same_epochs(runs):
    """Both ranks ran both runs and report the same epoch metrics, which are
    the global batch's (averaged and summed over the ranks); the resumed
    run trained epoch 2 only."""
    first = [r["first"]["results"] for r in runs["ranks"]]
    assert [e["epoch"] for e in first[0]] == [0, 1] and first[0][1]["qat_enabled"]
    for a, b in zip(*first):
        assert {k: a[k] for k in SHARED} == {k: b[k] for k in SHARED}
    resumed = [r["resumed"]["results"] for r in runs["ranks"]]
    assert [e["epoch"] for e in resumed[0]] == [2] == [e["epoch"] for e in resumed[1]]
    assert {k: resumed[0][0][k] for k in SHARED} == {k: resumed[1][0][k] for k in SHARED}
    assert runs["ranks"][0]["first"]["final_quant_acc"] == runs["ranks"][1]["first"][
        "final_quant_acc"]
    # the eval ran on each rank's shard: ceil(ceil(37 / 2) / 8) = 3 batches, not 5
    assert [e["eval_batches"] for e in first[0]] == [3, 3]


def test_two_ranks_match_one_process_at_twice_the_batch(runs):
    """The two ranks at B each against one process at 2B over the same
    images. The float epoch: loss within f32 tolerance (rtol 1e-5), the same
    top-1. The QAT epoch continues from parameters that the float epoch left
    apart by f32 summation order, and fake-quant rounding amplifies that
    (the step tests hold each DP step to one process's from the SAME state,
    within 1e-5; free-running, the QAT trajectories part, as they do
    between the port and JAX): its loss within rtol 1e-3 (measured 3.8e-4),
    its fake-quant and int8 top-1 within one test image."""
    mine = runs["ranks"][0]["first"]["results"]
    one = runs["one"]["results"]
    assert len(mine) == len(one) == 2 and not mine[0]["qat_enabled"] and mine[1]["qat_enabled"]
    np.testing.assert_allclose(mine[0]["train_loss"], one[0].train_loss, rtol=1e-5)
    assert (mine[0]["qat_acc"], mine[0]["quant_acc"]) == (one[0].qat_acc, one[0].quant_acc)
    np.testing.assert_allclose(mine[1]["train_loss"], one[1].train_loss, rtol=1e-3)
    for key in ("qat_acc", "quant_acc"):
        assert abs(mine[1][key] - getattr(one[1], key)) <= 1 / N_TEST + 1e-12, key


def test_rank_zero_alone_writes(runs):
    """Rank 0 wrote JAX's artifact set; rank 1 wrote nothing (its output
    directory was never made)."""
    tmp = runs["tmp"]
    assert ARTIFACTS <= set(os.listdir(tmp / "out0"))
    assert not (tmp / "out1").exists()
    assert os.path.isfile(tmp / "mlflow_dp.db")


def test_files_read_in_jax_without_ddp_prefix(runs, jax_templates):  # noqa: F811
    """The two-rank run's files read in the JAX package's
    ``load_checkpoint`` against JAX-built templates, keys, shapes and dtypes
    equal; no key anywhere carries DDP's ``module.`` prefix; the resume file
    is the resumed run's (epoch 2)."""
    from qat_vit_tpu.utils import checkpoint as jck

    out = runs["tmp"] / "out0"
    for name, template in (("best_converted", "best_converted"), ("resume_state", "resume_state")):
        tmpl = jax_templates[template]
        restored = jck.load_checkpoint(str(out / f"{name}.msgpack"), tmpl)
        assert _spec(restored) == _spec(tmpl), name
    for name in ("best_qat", "best_converted", "resume_state"):
        keys = _spec(load_checkpoint(str(out / f"{name}.msgpack")))
        assert not any("module" in k.split("/") for k in keys), name
    resume = load_checkpoint(str(out / "resume_state.msgpack"))
    assert int(resume["epoch"]) == 2 and int(resume["qat_enabled"]) == 1
    assert jax.tree.leaves(resume)
