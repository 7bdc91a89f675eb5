"""Port parity: tensor parallelism (``qat_vit_tpu_torch/parallel/tensor.py``)
on the CPU, against the port's one-process step and the JAX package's step
on a mesh with a model axis.

In one process: the split of ViT-S's geometry and its gather round trip,
exact at even and uneven head counts; a rank's qkv rows are its heads' rows
in each of q, k and v; ``model > num_heads`` and a model axis the world
does not divide raise; a resume file assembled from shards is byte-identical
to the one-process file.

On gloo ranks (``parallel/dryrun.py``'s worker, ``device="cpu"``, one torch
thread a rank): one spawn of two ranks (``data 1 x model 2``) and one of
four (``data 2 x model 2``), started together once this process has
written every state and batch (from the port's seeded start: the ranks wait
on nothing of JAX's, which runs here meanwhile). Each takes a micro ViT's
float step and observing QAT step from the same state on the same global
batch as:

- the port's one-process step: loss rtol 1e-5, every parameter (gathered)
  within the DP tests' tolerances (rel L2 1e-4; rtol 1e-4, atol 1.5e-4),
  weight observers identical, activation observers rtol 1e-6;
- JAX's trainer step on ``make_mesh(data=1, model=2)`` and
  ``make_mesh(data=2, model=2)`` (replicated params, the batch on the data
  axis, GSPMD): loss rtol 1e-5 (``tests/test_train_parallel.py``); where
  a QAT step parts from JAX's by a fake-quant rounding flip (f32 sums in
  another order), the rule of ``tests/test_torch_port_parallel.py``: each
  package's TP step is held to its own one-process step, and the two TP
  steps part by no more than the one-process steps part by.

Each rank holds only its shard of qkv / proj / fc1 / fc2 and of their AdamW
moments. The two-rank spawn also runs ``train_main`` (its files, written by
rank 0 from gathered tensors, read by one process and written back
byte-identical) and resumes it, the search driver, and the tensor-parallel
dry run (float, QAT, and QAT under ``remat="dots"``).
"""

import os
import threading

import numpy as np
import pytest
import torch

import jax

from qat_vit_tpu.models.registry import create_model as jax_create_model
from qat_vit_tpu.parallel import make_mesh as jax_make_mesh
from qat_vit_tpu.parallel import replicated_sharding as jax_replicated
from qat_vit_tpu.parallel import shard_batch as jax_shard_batch
from qat_vit_tpu.quant.qconfig import default_qat_qconfig as jax_qconfig
from qat_vit_tpu.train import steps as jax_steps
from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
from qat_vit_tpu_torch.models import jax_params
from qat_vit_tpu_torch.models.registry import create_model
from qat_vit_tpu_torch.parallel import dryrun, tensor
from qat_vit_tpu_torch.parallel.mesh import Mesh, make_mesh
from qat_vit_tpu_torch.train import steps
from qat_vit_tpu_torch.train import trainer as tr
from qat_vit_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tests.test_torch_port_parallel import _jax_batch, _jax_start, _port_state
from tests.test_torch_port_train import _leaves

LR, WD, CLIP = 1e-3, 1e-3, 0.05  # CLIP below the micro model's gradient norms
GLOBAL_B = 8
LOSS_RTOL, OBS_RTOL, PARAM_RTOL, PARAM_ATOL, PARAM_REL_L2 = 1e-5, 1e-6, 1e-4, 1.5e-4, 1e-4
GRIDS = ((1, 2), (2, 2))  # (data, model)
CASES = {"float": False, "qat": True}
TIMEOUT_S = 150


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
# one process: the split
# ---------------------------------------------------------------------------

def _vit_s(depth=2):
    """ViT-S/16's geometry (D 384, 6 heads, MLP 1,536), depth cut to 2: its
    state dict, QAT observers included, and config."""
    bundle = create_model("vit_small_patch16_224_student", qat_wrapper=True, depth=depth,
                          generator=torch.Generator().manual_seed(0))
    sd = bundle.module.state_dict()
    return {k: v + 0.001 * i if v.is_floating_point() else v
            for i, (k, v) in enumerate(sd.items())}, bundle.cfg


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_split_gather_round_trip(k):
    """``join(split(p)) == p`` exactly at ViT-S's geometry over k ranks,
    even (2, 3, 6) and uneven (4: heads 2, 2, 1, 1; 5: 2, 1, 1, 1, 1); the
    shards' heads and MLP shares are ``np.array_split``'s, and the split
    entries are qkv / fc1 (weight and bias) and the proj / fc2 weights."""
    full, cfg = _vit_s()
    shards = [tensor.split_state(full, cfg, k, m) for m in range(k)]
    back = tensor.join_params(shards, cfg)
    assert back.keys() == full.keys()
    assert all(torch.equal(back[n], full[n]) for n in full)
    heads = [len(a) for a in np.array_split(np.arange(cfg.num_heads), k)]
    mlp = [len(a) for a in np.array_split(np.arange(cfg.mlp_dim), k)]
    assert [tensor.head_bounds(cfg, k, m)[1] - tensor.head_bounds(cfg, k, m)[0]
            for m in range(k)] == heads
    hd, d = cfg.head_dim, cfg.embed_dim
    for m, s in enumerate(shards):
        assert s["blocks.1.attn.qkv.weight"].shape == (3 * heads[m] * hd, d)
        assert s["blocks.1.attn.qkv.bias"].shape == (3 * heads[m] * hd,)
        assert s["blocks.1.attn.proj.weight"].shape == (d, heads[m] * hd)
        assert s["blocks.1.mlp.fc1.weight"].shape == (mlp[m], d)
        assert s["blocks.1.mlp.fc1.bias"].shape == (mlp[m],)
        assert s["blocks.1.mlp.fc2.weight"].shape == (d, mlp[m])
    split = sorted(n for n in full if tensor.is_split(n, cfg))
    assert split == sorted(f"blocks.{b}.{n}" for b in range(2) for n in (
        "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight", "mlp.fc1.weight",
        "mlp.fc1.bias", "mlp.fc2.weight"))
    for n in full:
        if n not in split:
            assert all(s[n] is full[n] for s in shards), n  # replicated, untouched


def test_qkv_shard_is_heads_in_q_k_and_v():
    """Rank m's qkv rows are its heads' rows in each of q, k and v (qkv's
    rows are ``(3, H, hd)``), never a contiguous third of 3D; proj's
    columns are the same heads; fc1's rows and fc2's columns a contiguous
    share of the MLP width."""
    full, cfg = _vit_s()
    d, hd, k = cfg.embed_dim, cfg.head_dim, 4
    w = full["blocks.0.attn.qkv.weight"]
    for m in range(k):
        lo, hi = tensor.head_bounds(cfg, k, m)
        s = tensor.split_state(full, cfg, k, m)
        want = torch.cat([w[i * d + lo * hd:i * d + hi * hd] for i in range(3)])
        assert torch.equal(s["blocks.0.attn.qkv.weight"], want)
        third = w[m * s["blocks.0.attn.qkv.weight"].shape[0]:][:len(want)]
        assert not torch.equal(s["blocks.0.attn.qkv.weight"], third)
        assert torch.equal(s["blocks.0.attn.proj.weight"],
                           full["blocks.0.attn.proj.weight"][:, lo * hd:hi * hd])
        a, b = tensor.share(cfg.mlp_dim, k, m)
        assert torch.equal(s["blocks.0.mlp.fc1.weight"], full["blocks.0.mlp.fc1.weight"][a:b])
        assert torch.equal(s["blocks.0.mlp.fc2.weight"], full["blocks.0.mlp.fc2.weight"][:, a:b])


def test_model_axis_refusals():
    """``model > num_heads`` raises a ``ValueError`` naming the residue; in
    a world of one a model axis raises JAX's mesh error (the world does not
    divide it), from ``make_mesh`` and from ``KDQATTrainer``; a device list
    carries no model axis."""
    full, cfg = _vit_s()
    with pytest.raises(ValueError, match="Queue 3"):
        tensor.split_state(full, cfg, 7, 0)
    module = dryrun.micro_vit(False).module
    with pytest.raises(ValueError, match="Queue 3"):
        tensor.shard_module(module, Mesh(data=1, model=3))
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        make_mesh(model=2)
    with pytest.raises(ValueError, match=r"mesh 1x2 != 1 devices"):
        make_mesh(data=1, model=2)
    with pytest.raises(ValueError, match="device list"):
        make_mesh(model=2, devices=["cpu", "cpu"])
    data = synthetic_cifar10(n_train=16, n_test=8)
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        dryrun._micro_trainer(dryrun.micro_trainer_hp(model_parallel=2), "cpu", data)
    assert make_mesh(devices=["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2


def test_resume_file_from_shards_is_one_process_file(tmp_path):
    """A QAT trainer's resume tree gathered from two ranks' shards of its
    parameters and AdamW moments (split, then joined) writes the same bytes
    as the one-process tree; so does the checkpoint of its parameters and
    observers."""
    data = synthetic_cifar10(n_train=16, n_test=8)
    t = dryrun._micro_trainer(dryrun.micro_trainer_hp(), "cpu", data)
    t.enable_qat()
    t.train_epoch(0, limit_batches=1)
    cfg = t.student_qat_cfg

    def via_shards(sd):
        return tensor.join_params([tensor.split_state(sd, cfg, 2, m) for m in range(2)], cfg)

    for name, gather in (("one", None), ("shards", via_shards)):
        tree = tr.resume_tree(t.state, True, 0, gather=gather)
        save_checkpoint(str(tmp_path / f"{name}.msgpack"), tree)
        sd = (gather or dict)(t.state.module.state_dict())
        save_checkpoint(str(tmp_path / f"{name}_best.msgpack"),
                        {"params": jax_params.state_dict_to_params(sd),
                         "quant_stats": jax_params.buffers_to_quant_stats(sd)})
    for suffix in ("", "_best"):
        with open(tmp_path / f"one{suffix}.msgpack", "rb") as a, \
                open(tmp_path / f"shards{suffix}.msgpack", "rb") as b:
            assert a.read() == b.read()


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _jax_step(qat):
    quant = jax_qconfig() if qat else None
    module = jax_create_model(dryrun.MICRO_VIT, qat_wrapper=qat, quant=quant).module
    tx = jax_steps.make_optimizer(LR, WD, CLIP)
    return tx, jax_steps.make_train_step(None, module.apply, tx, qat=qat, image_size=32,
                                         donate=False)


def _expected(state, metrics):
    return {"params": jax_params.params_to_state_dict(jax.device_get(state.params)),
            "stats": _leaves(jax.device_get(state.quant_stats)) if state.quant_stats else {},
            "metrics": {k: float(v) for k, v in jax.device_get(metrics).items()}}


def _hp(d):
    return dryrun.micro_trainer_hp(model_parallel=2, epochs=2, qat_start_epoch=1,
                                   limit_train_batches=2, output_dir=d + "/main{rank}",
                                   mlflow_uri=f"sqlite:///{d}/main{{rank}}.db")


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """Every state and the global batches written for the ranks; the two
    spawns started together, with one torch thread a rank; meanwhile JAX's
    float and QAT steps on the (1, 2) and (2, 2) meshes and on one device
    from the same states here."""
    d = str(tmp_path_factory.mktemp("tp"))
    cases = [{"name": n, "qat": qat, "lr": LR, "wd": WD, "clip": CLIP} for n, qat in CASES.items()]
    expected, starts = {}, {}
    for c, (name, qat) in enumerate(CASES.items()):
        port = _port_state(False, qat, 1)
        starts[name] = _jax_start(port, qat, _jax_step(qat)[0])
        dryrun.save_state(os.path.join(d, f"{name}_state0.pt"), port)
        batch = dryrun.micro_batch(GLOBAL_B, 40 + c)
        dryrun.save_atomic({k: torch.from_numpy(v) for k, v in batch.items()},
                           os.path.join(d, f"{name}_batch0.pt"))
        expected[name, "batch"] = batch
    jobs = {(1, 2): [{"kind": "tp_steps", "dir": d, "data": 1, "model": 2, "cases": cases},
                     {"kind": "train_main", "hp": _hp(d), "n_train": 32, "n_test": 17},
                     {"kind": "train_main", "name": "resumed", "n_train": 32, "n_test": 17,
                      "hp": dict(_hp(d), epochs=3, resume=d + "/main0/resume_state.msgpack",
                                 output_dir=d + "/resumed{rank}",
                                 mlflow_uri=f"sqlite:///{d}/resumed{{rank}}.db")},
                     {"kind": "search", "n_train": 32, "n_test": 16, "cfg": dict(
                         micro=True, model_parallel=2, trials=2, epochs=2, batch_size=8,
                         eval_batch_size=8, limit_train_batches=1, limit_eval_batches=1,
                         output_dir=d + "/search{rank}",
                         mlflow_uri=f"sqlite:///{d}/search{{rank}}.db")},
                     {"kind": "tp_dryrun", "model": 2}],
            (2, 2): [{"kind": "tp_steps", "dir": d, "data": 2, "model": 2, "cases": cases}]}
    ranks, errors = {}, []

    def spawn(grid):
        try:
            out = os.path.join(d, "x".join(map(str, grid)))
            ranks[grid] = dryrun.run_ranks(
                {"device": "cpu", "out": out, "timeout_s": TIMEOUT_S, "threads": 1,
                 "tasks": jobs[grid]}, grid[0] * grid[1], timeout_s=TIMEOUT_S)
        except Exception as e:  # raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=spawn, args=(g,)) for g in GRIDS]
    for th in threads:
        th.start()
    try:
        for name, qat in CASES.items():
            _, step = _jax_step(qat)
            batch = _jax_batch(expected[name, "batch"])
            lhp = jax_steps.loss_hparams(dryrun.LOSS_HP)
            for data, model in GRIDS:
                mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
                expected[name, data, model] = _expected(*step(
                    jax.device_put(starts[name], jax_replicated(mesh)), None,
                    jax_shard_batch(batch, mesh), lhp))
            expected[name, "one"] = _expected(*step(starts[name], None, batch, lhp))
    finally:
        for th in threads:
            th.join()
    if errors:
        raise errors[0]
    return {"dir": d, "ranks": ranks, "expected": expected, "one_process": {}}


def _tp_out(run, name, grid):
    return torch.load(os.path.join(run["dir"], f"{name}_tp{grid[0]}x{grid[1]}.pt"),
                      weights_only=True)


def _port_one_process(run, name):
    """The port's step in one process from the case's state on the whole
    global batch: (metrics, state dict, AdamW moments by name, qkv grads);
    once a case."""
    if name in run["one_process"]:
        return run["one_process"][name]
    qat = CASES[name]
    quant = dryrun.micro_qconfig(model_axis=True) if qat else None
    module = dryrun.micro_vit(qat, quant=quant).module
    state = steps.TrainState(module, steps.make_optimizer(module.parameters(), LR, WD, CLIP))
    dryrun.load_state(os.path.join(run["dir"], f"{name}_state0.pt"), state)
    batch = torch.load(os.path.join(run["dir"], f"{name}_batch0.pt"), weights_only=True)
    metrics = dryrun._step_fn(False, qat, True)(state, batch, dryrun._loss_hp(False, "cpu"))
    adam = state.optimizer.adamw.state
    run["one_process"][name] = (
        {k: float(v) for k, v in metrics.items()}, module.state_dict(),
        {n: adam[p] for n, p in module.named_parameters()},
        {n: p.grad for n, p in module.named_parameters() if "qkv.weight" in n})
    return run["one_process"][name]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


CHECKS = [(n, g) for n in CASES for g in GRIDS]


@pytest.mark.parametrize("name,grid", CHECKS)
def test_tp_step_matches_one_process(tp_run, name, grid):
    """The TP step, gathered, against the port's one-process step on the
    global batch from the same state: loss rtol 1e-5; every parameter
    within rel L2 1e-4 and elementwise rtol 1e-4 / atol 1.5e-4; the AdamW
    moments and the qkv gradients too; weight observers identical,
    activation observers rtol 1e-6."""
    metrics, sd, adam, grads = _port_one_process(tp_run, name)
    out = _tp_out(tp_run, name, grid)
    for k, v in metrics.items():
        np.testing.assert_allclose(out["metrics"][k], v, rtol=LOSS_RTOL, err_msg=k)
    names = [n for n in sd if not n.endswith(("min_val", "max_val"))]
    got = np.concatenate([out["module"][n].numpy().ravel() for n in names])
    want = np.concatenate([sd[n].numpy().ravel() for n in names])
    assert _rel_l2(got, want) <= PARAM_REL_L2
    for n in names:
        np.testing.assert_allclose(out["module"][n].numpy(), sd[n].numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=n)
    for key in ("exp_avg", "exp_avg_sq"):
        got = np.concatenate([out["moments"][key][n].numpy().ravel() for n in names])
        want = np.concatenate([adam[n][key].numpy().ravel() for n in names])
        assert _rel_l2(got, want) <= PARAM_REL_L2, key
    for n, g in grads.items():
        assert _rel_l2(out["qkv_grad"][n].numpy(), g.numpy()) <= PARAM_REL_L2, n
    obs = [n for n in sd if n.endswith(("min_val", "max_val"))]
    assert bool(obs) == CASES[name]
    for n in obs:
        assert torch.isfinite(out["module"][n]), n
        if "weight_fq" in n:
            assert torch.equal(out["module"][n], sd[n]), n
        else:
            np.testing.assert_allclose(out["module"][n].numpy(), sd[n].numpy(), rtol=OBS_RTOL,
                                       err_msg=n)


@pytest.mark.parametrize("name,grid", CHECKS)
def test_tp_step_matches_jax_mesh(tp_run, name, grid):
    """The TP step against JAX's trainer step on ``make_mesh(data, model)``
    from the same state on the same global batch: loss rtol 1e-5, params
    rtol 1e-4 / atol 1.5e-4, observers rtol 1e-6. Where a QAT step parts
    from JAX's (a fake-quant rounding flip, as on one device), each
    package's TP step is held to its own one-process step (the port's in
    ``test_tp_step_matches_one_process``) and the TP steps part by what the
    one-process steps part by: loss, parameters and observers."""
    want = tp_run["expected"][name, grid[0], grid[1]]
    out = _tp_out(tp_run, name, grid)
    params = {k: out["module"][k].numpy() for k in want["params"]}
    stats = _leaves(jax_params.buffers_to_quant_stats(out["module"])) if CASES[name] else {}
    assert stats.keys() == want["stats"].keys()
    loss, jloss = out["metrics"]["train_loss"], want["metrics"]["train_loss"]
    direct = np.isclose(loss, jloss, rtol=LOSS_RTOL, atol=0) and all(
        np.allclose(params[k], v.numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL)
        for k, v in want["params"].items()) and all(
        np.allclose(stats[k], v, rtol=OBS_RTOL, atol=0) for k, v in want["stats"].items())
    if direct:
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(out["metrics"][k], v, rtol=LOSS_RTOL, err_msg=k)
        return
    assert CASES[name], "the float TP step parts from JAX's"
    p_metrics, p_sd, _, _ = _port_one_process(tp_run, name)
    j1 = tp_run["expected"][name, "one"]
    np.testing.assert_allclose(jloss, j1["metrics"]["train_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss - jloss, p_metrics["train_loss"] - j1["metrics"]["train_loss"],
                               rtol=0, atol=LOSS_RTOL * abs(jloss))
    for k, v in want["params"].items():
        jp = j1["params"][k].numpy()
        np.testing.assert_allclose(v.numpy(), jp, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
        parting = np.abs((params[k] - v.numpy()) - (p_sd[k].numpy() - jp))
        assert (parting <= PARAM_ATOL + PARAM_RTOL * np.abs(jp)).all(), (k, parting.max())
    p_stats = _leaves(jax_params.buffers_to_quant_stats(p_sd))
    for k, v in want["stats"].items():
        js = j1["stats"][k]
        np.testing.assert_allclose(v, js, rtol=OBS_RTOL, err_msg=k)
        parting = np.abs((stats[k] - v) - (p_stats[k] - js))
        assert (parting <= OBS_RTOL * np.abs(js)).all(), (k, parting)


@pytest.mark.parametrize("grid", GRIDS)
def test_ranks_hold_their_shards(tp_run, grid):
    """Each rank holds only its shard of the split weights and of their
    AdamW moments (the micro ViT's 2 heads of 64 and MLP 512 over 2 model
    ranks: one head and 256 each); the gathered parameters are the same on
    every rank."""
    d, hd, mlp = 128, 64, 256
    want = {"attn.qkv.weight": [3 * hd, d], "attn.qkv.bias": [3 * hd],
            "attn.proj.weight": [d, hd], "mlp.fc1.weight": [mlp, d], "mlp.fc1.bias": [mlp],
            "mlp.fc2.weight": [d, mlp]}
    want = {f"blocks.{b}.{k}": v for b in range(2) for k, v in want.items()}
    for r in tp_run["ranks"][grid]:
        for name in CASES:
            got = r["tp_steps"][name]
            assert got["params"] == want and got["moments"] == want, (name, got)
            assert got["ranks_identical"], name


def test_train_main_on_two_tp_ranks(tp_run):
    """``train_main`` with ``model_parallel`` 2 on two ranks (a float and a
    QAT epoch, the int8 export, its eval): the same results on both ranks,
    files from rank 0 alone; resumed from its file (split on each rank) it
    trains epoch 2 alone, the same on both ranks; its resume file,
    ``best_qat`` and ``best_converted``, read by one process and written
    back, are byte-identical."""
    d = tp_run["dir"]
    for task, epochs in (("train_main", [0, 1]), ("resumed", [2])):
        a, b = (r[task] for r in tp_run["ranks"][1, 2])
        for r in a["results"] + b["results"]:
            assert r.pop("imgs_per_sec") > 0  # this rank's host clock
        assert a == b and [r["epoch"] for r in a["results"]] == epochs
        assert a["results"][-1]["qat_enabled"] and np.isfinite(a["results"][-1]["train_loss"])
    assert not os.path.exists(os.path.join(d, "main1"))
    out = os.path.join(d, "main0")
    data = synthetic_cifar10(n_train=32, n_test=17, seed=1)
    t = dryrun._micro_trainer(dryrun.micro_trainer_hp(), "cpu", data)
    path = os.path.join(out, "resume_state.msgpack")
    assert t.load_resume_state(path) == 2 and t.qat_enabled
    again = t.save_resume_state(os.path.join(d, "again.msgpack"), epoch=1)
    for name in ("best_qat.msgpack", "best_converted.msgpack"):
        save_checkpoint(os.path.join(d, "again_" + name),
                        load_checkpoint(os.path.join(out, name)))
    pairs = [(path, again)] + [(os.path.join(out, n), os.path.join(d, "again_" + n))
                               for n in ("best_qat.msgpack", "best_converted.msgpack")]
    for x, y in pairs:
        with open(x, "rb") as f, open(y, "rb") as g:
            assert f.read() == g.read(), x
    # the export converted from the gathered weights is the one-process conversion
    export = t.convert_int8()
    saved = load_checkpoint(os.path.join(out, "best_converted.msgpack"))
    for layer in ("qkv", "proj", "fc1", "fc2"):
        assert np.array_equal(np.asarray(saved["blocks"]["0"][layer]["w_int8"]),
                              export["blocks"]["0"][layer]["w_int8"].numpy()), layer


def test_search_and_dryrun_on_two_tp_ranks(tp_run):
    """The search driver with ``model_parallel`` 2 (2 trials) on two ranks:
    the same best trial on both; the package's TP dry run (float, QAT and
    QAT under ``remat="dots"`` steps against one process) passed on both."""
    a, b = (r["search"] for r in tp_run["ranks"][1, 2])
    assert a == b and np.isfinite(a["best_value"])
    for r in tp_run["ranks"][1, 2]:
        for name in ("float", "qat", "qat_remat_dots"):
            g = r["tp_dryrun"][name]
            assert g["ranks_identical"] and g["weight_obs_equal"], name
            assert g["loss_rel"] <= LOSS_RTOL and g["params_rel_l2"] <= PARAM_REL_L2, (name, g)
