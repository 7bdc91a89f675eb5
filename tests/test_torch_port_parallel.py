"""Port parity: data parallelism over ``torch.distributed`` ranks against the
JAX package's ``shard_map`` data-parallel step on a 2-device mesh, on the CPU.

Two gloo ranks run the port's DP steps (``parallel/dryrun.py``'s worker,
``device="cpu"``): DDP averages the gradients before clip → AdamW, the
activation observers reduce their min/max over the ranks
(``FakeQuantConfig.axis_name``). JAX runs ``make_train_step(mesh=...)`` /
``make_detect_train_step(mesh=...)`` on ``make_mesh(data=2)`` with the
activation observers' ``axis_name=DATA_AXIS``. Before every step both take
the same state (the JAX state, loaded into the ranks), and rank r takes JAX
device r's contiguous rows of the same global batch. Cases: float, observing
QAT, observer-frozen QAT, ``observer_stride`` 2 (the prefix of each rank's
shard) and one detection QAT step; JAX's own tolerances
(``tests/test_train_parallel.py``): loss rtol 1e-5, observer min/max rtol
1e-6, params rtol 1e-4 / atol 1.5e-4.

Also: the two ranks against the port's one-process step on the global
batch; the rank-sharded eval (float, fake-quant, int8) against one process
on a test set of odd size; the rank helpers in a world of 2; the guard on a
QAT step whose observers lack the axis; a world of one through DDP,
identical to no process group; ``Int8Predictor`` over a 2-device mesh
identical to one device; the loader's rank shards; ``model_parallel`` > 1
refused in a world of one, as JAX's mesh refuses it. Every rank case runs in
ONE spawn of two ranks (module fixture), its results under ``tmp_path``.
"""

import dataclasses
import datetime
import os

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from qat_vit_tpu.models.owlv2_detect import create_detector as jax_create_detector
from qat_vit_tpu.models.registry import create_model as jax_create_model
from qat_vit_tpu.parallel import make_mesh as jax_make_mesh
from qat_vit_tpu.parallel import shard_batch as jax_shard_batch
from qat_vit_tpu.parallel.mesh import DATA_AXIS as JAX_DATA_AXIS
from qat_vit_tpu.quant.qconfig import default_qat_qconfig as jax_qconfig
from qat_vit_tpu.train import detect_steps as jax_detect_steps
from qat_vit_tpu.train import steps as jax_steps
from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
from qat_vit_tpu_torch.data.pipeline import ArrayLoader
from qat_vit_tpu_torch.models import jax_params
from qat_vit_tpu_torch.parallel import dryrun
from qat_vit_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    get_dist_info,
    make_mesh,
    pick_free_port,
)
from qat_vit_tpu_torch.serve.int8_vit import convert_vit
from qat_vit_tpu_torch.serve.predictor import Int8Predictor
from qat_vit_tpu_torch.train import steps
from qat_vit_tpu_torch.train.detect_steps import make_detect_train_step
from qat_vit_tpu_torch.train.trainer import trainer_mesh
from tests.test_torch_port_train import _leaves, _pow2_scales, _sync_to_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WORLD, B = 2, 4  # ranks, rows per rank
LR, WD, CLIP = 1e-3, 1e-3, 0.05  # CLIP below the micro models' gradient norms
LOSS_RTOL, OBS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6, 1e-4, 1.5e-4
# case: (detection, qat, observe flags by step, observer_stride); "qat"'s
# third step is the observer-frozen one
CASES = {"float": (False, False, (True, True), 1),
         "qat": (False, True, (True, True, False), 1),
         "stride2": (False, True, (True,), 2),
         "detect": (True, True, (True,), 1)}
# the parametrized checks: (case, its steps)
CHECKS = {"float": ("float", (0, 1)), "qat": ("qat", (0, 1)), "frozen": ("qat", (2,)),
          "stride2": ("stride2", (0,)), "detect": ("detect", (0,))}
N_TEST = 37  # odd: the two ranks' shards are 19 and 18 rows, padded to 3 batches of 8


def _jax_qconfig(stride, axis=True):
    qc = jax_qconfig()
    return dataclasses.replace(qc, activation=dataclasses.replace(
        qc.activation, axis_name=JAX_DATA_AXIS if axis else None, observe_stride=stride))


def _port_state(det, qat, stride):
    """A port ``TrainState`` of the case's model (seeded): the states'
    start, and the carrier of JAX states into the ranks' files."""
    quant = dryrun.micro_qconfig(stride=stride) if qat else None
    module = (dryrun.micro_detector(qat, quant=quant)[0] if det
              else dryrun.micro_vit(qat, quant=quant).module)
    return steps.TrainState(module, steps.make_optimizer(module.parameters(), LR, WD, CLIP))


def _jax_steps(det, qat, stride, mesh):
    """JAX's step makers by ``observe``: under ``shard_map`` on ``mesh``
    (activation observers on the data axis), or on one device."""
    quant = _jax_qconfig(stride, axis=mesh is not None) if qat else None
    if det:
        module, _ = jax_create_detector(quant=quant, pruned=True, qat_wrapper=qat,
                                        text_dim=dryrun.MICRO_TEXT_DIM, **dryrun.MICRO_DETECTOR)
        make = jax_detect_steps.make_detect_train_step
    else:
        module = jax_create_model(dryrun.MICRO_VIT, qat_wrapper=qat, quant=quant).module
        make = jax_steps.make_train_step
    tx = jax_steps.make_optimizer(LR, WD, CLIP)
    return tx, {obs: make(None, module.apply, tx, qat=qat, image_size=32, donate=False,
                          observe=obs, mesh=mesh, qconfig=quant if mesh is not None else None)
                for obs in (True, False)}


def _jax_start(port, qat, tx):
    """The JAX state of the port's seeded start: its parameters, fresh
    AdamW moments, its (unobserved) observers."""
    sd = port.module.state_dict()
    params = jax_params.state_dict_to_params(
        {k: v for k, v in sd.items() if not k.endswith(("min_val", "max_val"))})
    params = jax.tree.map(jnp.asarray, params)
    opt = jax_steps.set_optimizer_hyperparams(tx.init(params), learning_rate=LR, weight_decay=WD)
    stats = jax.tree.map(jnp.asarray, jax_params.buffers_to_quant_stats(sd)) if qat else None
    return jax_steps.TrainState(params=params, opt_state=opt, quant_stats=stats,
                                step=jnp.zeros((), jnp.int32))


def _loss_hps(det):
    return (jax_detect_steps.detect_loss_hparams(dryrun.LOSS_HP) if det
            else jax_steps.loss_hparams(dryrun.LOSS_HP))


def _jax_batch(batch):
    return {k: (v.astype(np.int32) if k == "label" else v) for k, v in batch.items()}


def _one_process_rows(stride):
    """The global batch's rows in the order under which ONE process's
    observers see what the ranks' see together: with ``observer_stride`` s
    each rank observes the prefix of its own shard, so those prefixes go
    first (min and max ignore the order; the loss and gradients are means)."""
    shard = np.arange(WORLD * B).reshape(WORLD, B)
    seen = B // stride
    return np.concatenate([shard[:, :seen].reshape(-1), shard[:, seen:].reshape(-1)])


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The JAX steps of every case, their states and batches written for
    the ranks; then ONE spawn of two gloo ranks running the cases, the eval,
    the rank helpers and the guard. The ranks start once every file is
    written, so their time limit covers their own work only (started
    first, they waited on this process, whose JAX steps take minutes on a
    host that runs other test files beside them)."""
    d = str(tmp_path_factory.mktemp("dp"))
    cases = [{"name": name, "detection": det, "qat": qat, "observe": list(observe),
              "stride": stride, "lr": LR, "wd": WD, "clip": CLIP}
             for name, (det, qat, observe, stride) in CASES.items()]
    job = {"device": "cpu", "out": d, "timeout_s": 120, "tasks": [
        {"kind": "info"}, {"kind": "guard"},
        {"kind": "steps", "dir": d, "cases": cases, "wait_s": 120},
        {"kind": "eval", "n_test": N_TEST, "state": os.path.join(d, "qat_out1_rank0.pt")},
        {"kind": "dryrun"}]}
    mesh = jax_make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    expected = {}
    for c, (name, (det, qat, observe, stride)) in enumerate(CASES.items()):
        tx, makers = _jax_steps(det, qat, stride, mesh)
        port = _port_state(det, qat, stride)
        state = _jax_start(port, qat, tx)
        for i, obs in enumerate(observe):
            if qat and not obs:
                state = _pow2_scales(state)
            _sync_to_jax(port.module, port.optimizer, state, qat)
            port.step = int(state.step)
            dryrun.save_state(os.path.join(d, f"{name}_state{i}.pt"), port)
            batch = dryrun.micro_batch(WORLD * B, 10 * c + i, detection=det)
            dryrun.save_atomic({k: torch.from_numpy(v) for k, v in batch.items()},
                               os.path.join(d, f"{name}_batch{i}.pt"))
            start = state
            state, metrics = makers[obs](state, None, jax_shard_batch(_jax_batch(batch), mesh),
                                         _loss_hps(det))
            expected[name, i] = {
                "start": start, "batch": batch,
                "params": jax_params.params_to_state_dict(jax.device_get(state.params)),
                "stats": _leaves(jax.device_get(state.quant_stats)) if qat else {},
                "metrics": {k: float(v) for k, v in jax.device_get(metrics).items()}}
    ranks = dryrun.run_ranks(job, WORLD, timeout_s=150)
    return {"dir": d, "ranks": ranks, "expected": expected}


def _rank_out(run, name, i, rank):
    return torch.load(os.path.join(run["dir"], f"{name}_out{i}_rank{rank}.pt"), weights_only=True)


def _port_one_process(run, name, i):
    """The port's step in one process from the step's state on the whole
    global batch (rows in :func:`_one_process_rows` order): (metrics, state
    dict after it)."""
    det, qat, observe, stride = CASES[name]
    state = _port_state(det, qat, stride)
    dryrun.load_state(os.path.join(run["dir"], f"{name}_state{i}.pt"), state)
    batch = torch.load(os.path.join(run["dir"], f"{name}_batch{i}.pt"), weights_only=True)
    rows = torch.from_numpy(_one_process_rows(stride))
    make = make_detect_train_step if det else steps.make_train_step
    metrics = make(None, qat=qat, image_size=32, observe=observe[i])(
        state, {k: v[rows] for k, v in batch.items()}, dryrun._loss_hp(det, "cpu"))
    return {k: float(v) for k, v in metrics.items()}, state.module.state_dict()


def _jax_one_process(run, name, i):
    """JAX's step on one device from the same state on the same rows:
    (metrics, parameters after it)."""
    det, qat, observe, stride = CASES[name]
    _, makers = _jax_steps(det, qat, stride, None)
    want = run["expected"][name, i]
    batch = {k: v[_one_process_rows(stride)] for k, v in _jax_batch(want["batch"]).items()}
    state, metrics = makers[observe[i]](want["start"], None, batch, _loss_hps(det))
    return ({k: float(v) for k, v in jax.device_get(metrics).items()},
            jax_params.params_to_state_dict(jax.device_get(state.params)))


@pytest.mark.parametrize("check", list(CHECKS))
def test_dp_step_matches_jax_shard_map(dp_run, check):
    """Each step on two ranks against JAX's 2-device ``shard_map`` step from
    the same state on the same global batch: the metrics averaged over the
    ranks (loss rtol 1e-5), every parameter (rtol 1e-4, atol 1.5e-4), every
    observer (rtol 1e-6); the frozen step leaves the observers as they were.

    Where the fake-quant steps' loss or parameters part from JAX's, the
    parting must be the two packages' own on one device, exactly: f32 sums
    in another order move a fake-quant value across a rounding midpoint now
    and then (measured on this micro ViT at batch 8, one device: loss
    parted beyond 1e-5 at 4 of 12 seeds, 8 of 12 with stride 2), which is a
    different forward, not a data-parallel fault. Then each package's DP
    step must equal its one-process step on the same rows (the tolerances
    above), and the DP steps must part by what the one-process steps part
    by (loss within 1e-5, parameters within the parameter tolerance)."""
    name, step_ids = CHECKS[check]
    det, qat, observe, _ = CASES[name]
    for i in step_ids:
        want = dp_run["expected"][name, i]
        out = _rank_out(dp_run, name, i, 0)
        if qat:
            got = _leaves(jax_params.buffers_to_quant_stats(out["module"]))
            assert got.keys() == want["stats"].keys()
            assert all(np.isfinite(v).all() for v in got.values())
            for k, v in want["stats"].items():
                np.testing.assert_allclose(got[k], v, rtol=OBS_RTOL, err_msg=k)
        if not observe[i]:
            before = torch.load(os.path.join(dp_run["dir"], f"{name}_state{i}.pt"),
                                weights_only=True)["module"]
            for k, v in out["module"].items():
                if k.endswith("_val"):
                    assert torch.equal(v, before[k]), k
        params = {k: out["module"][k].numpy() for k in want["params"]}
        loss, jloss = out["metrics"]["train_loss"], want["metrics"]["train_loss"]
        direct = np.isclose(loss, jloss, rtol=LOSS_RTOL, atol=0) and all(
            np.allclose(params[k], v.numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL)
            for k, v in want["params"].items())
        if direct:
            for k, v in want["metrics"].items():
                np.testing.assert_allclose(out["metrics"][k], v, rtol=LOSS_RTOL, err_msg=k)
            continue
        assert qat, "the float step parts from JAX's"
        p_metrics, p_sd = _port_one_process(dp_run, name, i)
        j_metrics, j_params = _jax_one_process(dp_run, name, i)
        np.testing.assert_allclose(loss, p_metrics["train_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(jloss, j_metrics["train_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(loss - jloss, p_metrics["train_loss"] - j_metrics["train_loss"],
                                   rtol=0, atol=LOSS_RTOL * abs(jloss))
        for k, v in want["params"].items():
            j1 = j_params[k].numpy()
            np.testing.assert_allclose(params[k], p_sd[k].numpy(), rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=k)
            np.testing.assert_allclose(v.numpy(), j1, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
            parting = np.abs((params[k] - v.numpy()) - (p_sd[k].numpy() - j1))
            assert (parting <= PARAM_ATOL + PARAM_RTOL * np.abs(j1)).all(), (k, parting.max())


@pytest.mark.parametrize("name", list(CASES))
def test_dp_ranks_identical(dp_run, name):
    """DDP keeps the ranks in step: after every step both ranks hold the
    same parameters, observers and metrics, bit for bit."""
    for i in range(len(CASES[name][2])):
        a, b = (_rank_out(dp_run, name, i, r) for r in range(WORLD))
        assert a["metrics"] == b["metrics"]
        assert a["module"].keys() == b["module"].keys()
        for k in a["module"]:
            assert torch.equal(a["module"][k], b["module"][k]), k


@pytest.mark.parametrize("check", list(CHECKS))
def test_dp_step_matches_one_process(dp_run, check):
    """The two ranks' step against the port's own step in one process on
    the whole global batch from the same state (with ``observer_stride``
    the rows that the ranks observe first): loss, parameters and observers
    within JAX's DP tolerances."""
    name, step_ids = CHECKS[check]
    for i in step_ids:
        metrics, sd = _port_one_process(dp_run, name, i)
        out = _rank_out(dp_run, name, i, 0)
        for k, v in metrics.items():
            np.testing.assert_allclose(out["metrics"][k], v, rtol=LOSS_RTOL, err_msg=k)
        for k, v in sd.items():
            tol = dict(rtol=OBS_RTOL) if k.endswith("_val") else dict(rtol=PARAM_RTOL,
                                                                        atol=PARAM_ATOL)
            np.testing.assert_allclose(out["module"][k].numpy(), v.numpy(), err_msg=k, **tol)


def test_sharded_eval_matches_one_process(dp_run):
    """The rank-sharded eval (each rank its strided shard ``rank::2``,
    padded to one batch count; counts summed) gives the one-process top-1
    of the whole odd-sized test set, float, fake-quant and int8: no padding
    row counted; each rank ran ceil(19 / 8) = 3 batches against 5."""
    state = torch.load(os.path.join(dp_run["dir"], "qat_out1_rank0.pt"),
                       weights_only=True)["module"]
    data = synthetic_cifar10(n_train=16, n_test=N_TEST, seed=3)
    t = dryrun._micro_trainer(dryrun.micro_trainer_hp(), "cpu", data)
    want = {"float": t.evaluate(), "float_batches": t.last_eval_batches}
    t.enable_qat()
    with torch.no_grad():
        t.student_qat.load_state_dict(state)
    want.update(qat=t.evaluate(), qat_batches=t.last_eval_batches, int8=t.evaluate_int8())
    assert want["float_batches"] == want["qat_batches"] == 5
    for rank in range(WORLD):
        got = dp_run["ranks"][rank]["eval"]
        assert got["float_batches"] == got["qat_batches"] == 3
        for k in ("float", "qat", "int8"):
            assert got[k] == want[k], (rank, k, got[k], want[k])


def test_dryrun_on_two_ranks(dp_run):
    """The package's dry run on the two ranks: float, observing QAT,
    frozen QAT, an observing QAT step with the qkv fake-quant inside the
    attention (kernel A's ``in_fq``, which reads the observer after its
    reduction over the ranks, as JAX's
    ``test_shard_map_dp8_fq_in_kernel_matches_single_device``) and a
    detection QAT step, each against one process on the global batch:
    JAX's DP tolerances, the ranks identical."""
    for r in dp_run["ranks"]:
        got = r["dryrun"]
        for name in ("float", "qat", "frozen", "qat_fq_in_kernel", "detection"):
            g = got[name]
            assert g["ranks_identical"], name
            assert g["loss_rel"] <= LOSS_RTOL and g["obs_rel"] <= OBS_RTOL, (name, g)
            assert g["params_rel_l2"] <= PARAM_RTOL, (name, g)
    assert dp_run["ranks"][0]["dryrun"] == dp_run["ranks"][1]["dryrun"]


def test_rank_helpers_world_of_two(dp_run):
    """``get_dist_info`` and ``barrier`` in a world of 2 on gloo."""
    for rank, r in enumerate(dp_run["ranks"]):
        assert r["info"] == {"world_size": 2, "rank": rank, "is_main_process": rank == 0,
                             "global_device_count": 2, "backend": "gloo"}


def test_qat_step_without_observer_axis_raises(dp_run):
    """In a world of 2 a QAT step whose activation observers lack the data
    axis raises (JAX's guard): it would train on per-rank statistics."""
    for r in dp_run["ranks"]:
        assert r["guard"]["raised"] and "axis_name" in r["guard"]["raised"]
        assert DATA_AXIS in r["guard"]["raised"]


def test_world_of_one_is_identical_to_no_process_group():
    """A gloo world of one: a QAT step through DDP (the all-reduce over one
    rank, the mean over one) and the observers' axis gives the same bits as
    the step with no process group, from the same state."""
    batch = {k: torch.from_numpy(v) for k, v in dryrun.micro_batch(B, 5).items()}
    lhp = dryrun._loss_hp(False, "cpu")
    step = steps.make_train_step(None, qat=True, image_size=32)
    plain = steps.TrainState(dryrun.micro_vit(True, quant=dryrun.micro_qconfig(axis=False)).module,
                             None)
    plain.optimizer = steps.make_optimizer(plain.module.parameters(), LR, WD, CLIP)
    want = step(plain, batch, lhp)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{pick_free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        info = get_dist_info()
        assert (info.world_size, info.rank) == (1, 0)
        state = dryrun._train_state(dryrun.micro_vit(True).module, "cpu", LR, WD, CLIP)
        assert state.replica is not None  # DDP in any process group
        got = step(state, batch, lhp)
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(got[k], want[k]) for k in want)
    sd = plain.module.state_dict()
    for k, v in state.module.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_mesh_predictor_matches_one_device():
    """``Int8Predictor(mesh=...)``: a replica per device, the batch split
    into equal contiguous shards; logits identical to one device's (odd N,
    padded); a batch size the mesh does not divide raises, as JAX's."""
    module = dryrun.micro_vit(True, quant=dryrun.micro_qconfig(axis=False)).module
    images = synthetic_cifar10(n_train=8, n_test=11, seed=4)["test_images"]
    from qat_vit_tpu_torch.data.pipeline import preprocess_fn

    with torch.no_grad():
        module(preprocess_fn(32)(torch.from_numpy(images)), observe=True)
    sd = module.state_dict()
    export = convert_vit(sd, sd, module.cfg)
    one = Int8Predictor(export, module.cfg, batch_size=8, device="cpu").logits(images)
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.devices == (torch.device("cpu"),) * 2
    got = Int8Predictor(export, module.cfg, batch_size=8, mesh=mesh).logits(images)
    assert got.shape == (11, 10) and np.isfinite(got).all()
    assert np.array_equal(got, one)
    with pytest.raises(ValueError, match="not divisible"):
        Int8Predictor(export, module.cfg, batch_size=7, mesh=mesh)


@pytest.mark.parametrize("rank", [0, 1])
def test_loader_rank_shards_match_jax(rank):
    """The port's ``ArrayLoader`` shard ``rank::2`` is JAX's, batch by
    batch, and the two ranks' first batches hold the one-process first
    batch at twice the size: ``perm[0::2][:B] | perm[1::2][:B] == perm[:2B]``."""
    from qat_vit_tpu.data.pipeline import ArrayLoader as JaxArrayLoader

    data = synthetic_cifar10(n_train=50, n_test=8, seed=2)
    kw = dict(batch_size=4, shuffle=True, seed=7, drop_last=True)
    ours = ArrayLoader(data["train_images"], data["train_labels"], rank=rank, world_size=2, **kw)
    theirs = JaxArrayLoader(data["train_images"], data["train_labels"], rank=rank, world_size=2,
                            **kw)
    ours.set_epoch(3)
    theirs.set_epoch(3)
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert np.array_equal(a["image"], b["image"]) and np.array_equal(a["label"], b["label"])
    one = ArrayLoader(data["train_images"], data["train_labels"], **dict(kw, batch_size=8))
    one.set_epoch(3)
    firsts = []
    for r in range(2):
        loader = ArrayLoader(data["train_images"], data["train_labels"], rank=r, world_size=2,
                             **kw)
        loader.set_epoch(3)
        firsts.append(next(iter(loader))["index"])
    assert sorted(np.concatenate(firsts).tolist()) == sorted(next(iter(one))["index"].tolist())


def test_model_parallel_still_refused():
    """In a world of one a model axis of 2 is refused with JAX's mesh error
    (the world does not divide it); a device list (the predictor's replicas)
    carries no model axis. Tensor parallelism runs on ranks
    (``tests/test_torch_port_tensor_parallel.py``)."""
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        trainer_mesh({"model_parallel": 2})
    with pytest.raises(ValueError, match="device list"):
        make_mesh(model=2, devices=["cpu", "cpu"])
