"""Data- and tensor-parallel dry run over ``torch.distributed`` ranks, and
its rank worker (the port's counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m qat_vit_tpu_torch.parallel.dryrun [N] [--model K] [--device cpu]

:func:`dryrun_multichip` starts ``N`` ranks (default 2; :func:`launch`, as
``torchrun`` would: one process each, ``RANK`` / ``WORLD_SIZE`` /
``MASTER_PORT`` in the environment) that each, on micro models, take one
float, one observing QAT and one observer-frozen QAT step through DDP, each
held to one process's step on the whole global batch from the same state;
run the rank-sharded eval; serve through a predictor with a replica per
device; and take one detection QAT step. With ``--model K`` > 1 the ranks
form an ``(N / K, K)`` rank grid instead and take one float and one QAT
tensor-parallel step of the micro ViT (:func:`tp_step_against_one_process`).
It prints one OK line.

:func:`run_job` is the rank's side (``python -m
qat_vit_tpu_torch.parallel.dryrun --job FILE``): it joins the process group
(``setup_distributed``), runs the job's tasks in order and writes each
rank's results under the job's ``out`` directory. Besides ``dryrun`` the
tasks are the steps of given states and batches (``steps``, and
``tp_steps`` on a rank grid), the sharded eval of a given state
(``eval``), the rank helpers (``info``), the guard on QAT steps without
the observers' axis (``guard``), ``train_main`` / ``detect_train_main`` on
micro models and synthetic data (``train_main``), the search driver
(``search``), the tensor-parallel dry run (``tp_dryrun``) and one split
bf16 layer of each kind (``tp_gemm``).

:func:`launch` kills every rank as soon as one fails or the time limit
passes, and raises: a lost rank fails the run instead of hanging it.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from qat_vit_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    all_reduce_mean,
    barrier,
    cleanup_distributed,
    get_dist_info,
    make_mesh,
    pick_free_port,
    setup_distributed,
    world_size,
)
from qat_vit_tpu_torch.parallel.tensor import gather_params, shard_module, split_params

RANK_TIMEOUT_S = 600.0
_ROOT = Path(__file__).resolve().parents[2]
# the dry run's micro models: ViT 2 blocks x 128 wide x 2 heads at 32 px; the
# detector 3 heads of 16 (17 tokens take the long-sequence pair)
MICRO_VIT = "vit_micro_test"
MICRO_DETECTOR = dict(image_size=32, patch_size=8, embed_dim=48, depth=2, num_heads=3,
                      mlp_ratio=2.0)
MICRO_TEXT_DIM, MICRO_QUERIES = 64, 3
MICRO_B = 4  # images per rank
LOSS_HP = {"kd_alpha": 0.5, "kd_temperature": 4.0, "label_smoothing": 0.1,
           "det_box_weight": 1.0, "det_obj_weight": 0.25}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def launch(args: Sequence[str], n_processes: int, log_dir: str, *,
           timeout_s: float = RANK_TIMEOUT_S, env: Optional[Dict[str, str]] = None) -> List[str]:
    """Run ``python ARGS`` as ranks 0..n-1 of one world on this host, as
    ``torchrun --standalone --nproc_per_node n`` would, from the
    repository's root, each rank's output into ``{log_dir}/rank{r}.log``;
    returns those outputs. Raises when a rank exits non-zero or the world
    outlives ``timeout_s``; every rank still running then is killed."""
    os.makedirs(log_dir, exist_ok=True)
    port = pick_free_port()
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = os.pathsep.join(p for p in (str(_ROOT), base.get("PYTHONPATH")) if p)
    procs, logs = [], []
    for rank in range(n_processes):
        rank_env = dict(base, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                        LOCAL_RANK=str(rank), WORLD_SIZE=str(n_processes),
                        LOCAL_WORLD_SIZE=str(n_processes))
        path = os.path.join(log_dir, f"rank{rank}.log")
        logs.append(path)
        with open(path, "w") as f:
            procs.append(subprocess.Popen([sys.executable, *args], cwd=str(_ROOT), env=rank_env,
                                          stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    codes = [None] * n_processes
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes) or any(c not in (None, 0) for c in codes):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outputs = []
    for path in logs:
        with open(path, errors="replace") as f:
            outputs.append(f.read())
    if not all(c == 0 for c in codes):
        tails = "\n".join(f"--- rank {r} (exit {c}) ---\n" + "\n".join(out.splitlines()[-30:])
                          for r, (c, out) in enumerate(zip(codes, outputs)))
        reason = "timed out" if any(c is None for c in codes) else "failed"
        raise RuntimeError(f"{n_processes} ranks of {' '.join(args)} {reason} "
                           f"(exit codes {codes}, None = killed)\n{tails}")
    return outputs


# ---------------------------------------------------------------------------
# a step against one process's step from the same state
# ---------------------------------------------------------------------------

def snapshot(state) -> Dict[str, Any]:
    """A copy of a ``TrainState``'s module state, AdamW state and step."""
    return {"module": {k: v.clone() for k, v in state.module.state_dict().items()},
            "adam": copy.deepcopy(state.optimizer.adamw.state_dict()),
            "step": state.step}


def restore(state, snap: Dict[str, Any]) -> None:
    with torch.no_grad():
        state.module.load_state_dict(snap["module"])
    state.optimizer.adamw.load_state_dict(copy.deepcopy(snap["adam"]))
    state.step = snap["step"]


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])


def ranks_identical(t: torch.Tensor) -> bool:
    """Whether ``t`` is the same on every rank (bit for bit)."""
    if world_size() == 1:
        return True
    lo, hi = t.clone(), t.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    return bool(torch.equal(lo, hi))


def _observers(module) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in module.state_dict().items() if k.endswith(("min_val", "max_val"))}


def step_against_one_process(state, step_fn: Callable, shard: Dict[str, torch.Tensor],
                             whole: Dict[str, torch.Tensor], loss_hp,
                             loss_key: str = "train_loss") -> Dict[str, Any]:
    """One data-parallel step of ``state`` on this rank's ``shard``, and
    from the same state one process's step (no DDP replica) on ``whole``,
    the global batch; the state goes on from the data-parallel step.

    Returns the readings: ``loss_rel`` (the loss averaged over the ranks
    against the one-process loss), ``grad_norm_rel`` (the global gradient
    norm before the clip), ``params_rel_l2`` (every parameter after
    the step, as one vector), ``obs_rel`` (the largest relative difference of
    an activation observer's min or max; 0 without observers),
    ``ranks_identical`` (parameters and observers the same on every rank) and
    the step's ``loss``. The one-process step's observers reduce over the
    ranks too: every rank holds the same global batch, so that is exact."""
    from qat_vit_tpu_torch.train.steps import TrainState

    snap = snapshot(state)
    one = TrainState(state.module, state.optimizer, state.step)
    ref_loss = float(step_fn(one, whole, loss_hp)[loss_key])
    ref_norm = float(state.optimizer.last_grad_norm)
    ref_params = _flat(state.module.parameters())
    ref_obs = {k: v.clone() for k, v in _observers(state.module).items()}
    restore(state, snap)
    loss = float(all_reduce_mean(step_fn(state, shard, loss_hp)[loss_key]))
    norm = float(state.optimizer.last_grad_norm)
    params = _flat(state.module.parameters())
    obs = _observers(state.module)
    act = [k for k in obs if "weight_fq" not in k and torch.isfinite(ref_obs[k])]
    obs_rel = max((float((obs[k] - ref_obs[k]).abs() / ref_obs[k].abs().clamp_min(1e-12))
                   for k in act), default=0.0)
    mine = _flat([params] + list(obs.values())) if obs else params
    return {"loss": loss, "loss_rel": abs(loss - ref_loss) / max(abs(ref_loss), 1e-12),
            "grad_norm_rel": abs(norm - ref_norm) / max(ref_norm, 1e-30),
            "params_rel_l2": float(torch.linalg.vector_norm(params - ref_params)
                                   / torch.linalg.vector_norm(ref_params).clamp_min(1e-30)),
            "obs_rel": obs_rel, "ranks_identical": ranks_identical(mine)}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def shard_shapes(module, optimizer) -> Dict[str, Dict[str, List[int]]]:
    """The shapes of this rank's shards of ``module``'s split parameters
    (``params``) and of their AdamW first moments (``moments``)."""
    split = [(n, p) for n, p in module.named_parameters() if hasattr(p, "tp_group")]
    return {"params": {n: list(p.shape) for n, p in split},
            "moments": {n: list(optimizer.adamw.state[p]["exp_avg"].shape) for n, p in split}}


def tp_step_against_one_process(module, mesh, step_fn: Callable, whole: Dict[str, torch.Tensor],
                                loss_hp, lr=1e-3, wd=1e-4, clip=1.0,
                                loss_key: str = "train_loss", timed_steps: int = 0
                                ) -> Dict[str, Any]:
    """One tensor-parallel step and one process's step, from the same state:
    ``module`` is a whole model in its start state (the same on every rank;
    left as it was). One process steps a copy of it on the global batch
    ``whole`` (its observers reduce over the ranks too, exactly: every rank
    holds the same batch); the rank steps another copy split over ``mesh``'s
    model axis (:func:`shard_module`, DDP over the data group) on its data
    shard. Both start with fresh AdamW moments.

    Returns the readings: ``loss_rel`` (the loss averaged over the ranks),
    ``grad_norm_rel`` (the global gradient norm before the clip),
    ``params_rel_l2`` (every parameter after the step, gathered),
    ``obs_rel`` (the largest relative difference of an observer's min or
    max, weights and activations; 0 without observers), ``weight_obs_equal``
    (the weight observers identical), ``qkv_grad_rel`` (the first block's qkv
    weight gradient after the clip, gathered), ``ranks_identical`` (the
    gathered parameters and observers the same on every rank), ``shards``
    (this rank's split parameters' and AdamW moments' shapes) and the
    step's ``loss``. With ``timed_steps`` n: ``ms``, per TP step over n more
    steps back to back on every rank, and ``one_process_ms``, per
    one-process step over n steps on rank 0 while the others wait, its
    observers not reducing over the ranks, as in one process (host clock
    from a barrier to a device sync)."""
    from qat_vit_tpu_torch.quant.modules import FakeQuantizer
    from qat_vit_tpu_torch.train.steps import TrainState, data_parallel, make_optimizer

    sync = torch.cuda.synchronize if whole["image"].is_cuda else (lambda: None)

    def timed(state, batch, mine=True):
        barrier("timed")
        if not mine:
            return None
        sync()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            step_fn(state, batch, loss_hp)
        sync()
        return (time.perf_counter() - t0) * 1e3 / timed_steps

    one = copy.deepcopy(module)
    one_state = TrainState(one, make_optimizer(one.parameters(), lr, wd, clip))
    ref = step_fn(one_state, whole, loss_hp)
    ref_norm = float(one_state.optimizer.last_grad_norm)
    ref_sd = {k: v.clone() for k, v in one.state_dict().items()}
    qkv = "blocks.0.attn.qkv.weight"
    ref_grad = one.get_parameter(qkv).grad.clone()

    tp = shard_module(copy.deepcopy(module), mesh)
    state = TrainState(tp, make_optimizer(tp.parameters(), lr, wd, clip), replica=data_parallel(tp))
    shard = shard_of(whole, mesh.data_index, mesh.data)
    got = step_fn(state, shard, loss_hp)
    loss = float(all_reduce_mean(got[loss_key]))
    norm = float(state.optimizer.last_grad_norm)
    sd = gather_params(tp.state_dict(), tp.cfg, mesh)
    grad = gather_params({qkv: tp.get_parameter(qkv).grad}, tp.cfg, mesh)[qkv]
    names = [n for n, _ in module.named_parameters()]
    params, ref_params = _flat([sd[n] for n in names]), _flat([ref_sd[n] for n in names])
    obs = [k for k in sd if k.endswith(("min_val", "max_val")) and torch.isfinite(ref_sd[k])]
    obs_rel = max((float((sd[k] - ref_sd[k]).abs() / ref_sd[k].abs().clamp_min(1e-12))
                   for k in obs), default=0.0)
    ref_loss = float(ref[loss_key])
    readings = {
        "loss": loss, "loss_rel": abs(loss - ref_loss) / max(abs(ref_loss), 1e-12),
        "grad_norm_rel": abs(norm - ref_norm) / max(ref_norm, 1e-30),
        "params_rel_l2": _rel(params, ref_params), "obs_rel": obs_rel,
        "weight_obs_equal": all(torch.equal(sd[k], ref_sd[k]) for k in obs if "weight_fq" in k),
        "qkv_grad_rel": _rel(grad, ref_grad),
        "ranks_identical": ranks_identical(_flat([params] + [sd[k] for k in obs])),
        "shards": shard_shapes(tp, state.optimizer)}
    if timed_steps:
        readings["ms"] = timed(state, shard)
        for m in one.modules():
            if isinstance(m, FakeQuantizer):
                m.cfg = dataclasses.replace(m.cfg, axis_name=None)
        readings["one_process_ms"] = timed(one_state, whole, get_dist_info().rank == 0)
        barrier("timed_end")
    return readings


def shard_of(batch: Dict[str, torch.Tensor], rank: int, world: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s contiguous rows of a global batch (JAX's device
    shard ``r`` under ``P("data")``)."""
    return {k: v.chunk(world)[rank] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# micro models and batches
# ---------------------------------------------------------------------------

def micro_qconfig(axis: bool = True, stride: int = 1, model_axis: bool = False):
    """The micro models' qconfig: the activation observers on the data axis
    (``axis``) and, with ``model_axis`` (a tensor-parallel step), the weight
    observers on the model axis."""
    from qat_vit_tpu_torch.quant.qconfig import default_qat_qconfig

    qc = default_qat_qconfig()
    qc = dataclasses.replace(qc, activation=dataclasses.replace(
        qc.activation, axis_name=DATA_AXIS if axis else None, observe_stride=stride))
    if model_axis:
        qc = dataclasses.replace(qc, weight=dataclasses.replace(qc.weight, axis_name=MODEL_AXIS))
    return qc


def micro_vit(qat: bool, seed: int = 0, quant=None, **cfg):
    from qat_vit_tpu_torch.models.registry import create_model

    quant = quant if quant is not None else (micro_qconfig() if qat else None)
    return create_model(MICRO_VIT, qat_wrapper=qat, quant=quant,
                        generator=torch.Generator().manual_seed(seed), **cfg)


def micro_detector(qat: bool, seed: int = 0, quant=None, **cfg):
    from qat_vit_tpu_torch.models.owlv2_detect import create_detector

    quant = quant if quant is not None else (micro_qconfig() if qat else None)
    return create_detector(pruned=True, qat_wrapper=qat, quant=quant, text_dim=MICRO_TEXT_DIM,
                           generator=torch.Generator().manual_seed(seed),
                           **{**MICRO_DETECTOR, **cfg})


def micro_batch(b: int, seed: int, detection: bool = False) -> Dict[str, np.ndarray]:
    """A seeded global batch of ``b`` images with cached-teacher targets."""
    rng = np.random.default_rng(seed)
    out = {"image": rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)}
    if detection:
        p = (32 // MICRO_DETECTOR["patch_size"]) ** 2
        out.update(query_embeds=rng.normal(0, 1, (b, MICRO_QUERIES, MICRO_TEXT_DIM)),
                   t_logits=rng.normal(0, 2, (b, p, MICRO_QUERIES)),
                   t_boxes=rng.uniform(0, 1, (b, p, 4)), t_obj=rng.normal(0, 2, (b, p)))
        return {k: (v.astype(np.float32) if v.dtype == np.float64 else v) for k, v in out.items()}
    out.update(label=rng.integers(0, 10, b).astype(np.int64),
               teacher_logits=rng.normal(0, 2, (b, 10)).astype(np.float32))
    return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# step states as files (the tests hand the ranks the JAX package's states)
# ---------------------------------------------------------------------------

def save_atomic(obj, path: str) -> None:
    """``torch.save`` published whole (tmp + rename): a rank waiting for
    the file never reads half of it."""
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def wait_for(path: str, timeout_s: float) -> None:
    """Wait until ``path`` exists (written by :func:`save_atomic`)."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout_s} s")
        time.sleep(0.05)


def save_state(path: str, state) -> None:
    """A ``TrainState``'s module state dict (parameters and observers),
    AdamW's moments by parameter name, its step count, lr and weight decay."""
    names = {p: n for n, p in state.module.named_parameters()}
    adam = state.optimizer.adamw
    save_atomic({"module": state.module.state_dict(),
                 "moments": {names[p]: dict(s) for p, s in adam.state.items()},
                 "hyperparams": state.optimizer.hyperparams, "step": state.step}, path)


def load_state(path: str, state, mesh=None) -> None:
    """:func:`save_state`'s file into ``state``; the whole state split for
    this rank of ``mesh`` when the module is split over its model axis."""
    from qat_vit_tpu_torch.train.steps import set_optimizer_hyperparams

    saved = torch.load(path, map_location="cpu", weights_only=True)
    cfg = state.module.cfg

    def split(sd):
        return split_params(sd, cfg, mesh) if mesh is not None else sd

    with torch.no_grad():
        state.module.load_state_dict(split(saved["module"]))
    set_optimizer_hyperparams(state.optimizer, **saved["hyperparams"])
    adam = state.optimizer.adamw
    adam.state.clear()
    moments = {k: split({n: m[k] for n, m in saved["moments"].items()})
               for k in ("exp_avg", "exp_avg_sq")}
    for name, p in state.module.named_parameters():
        if name in saved["moments"]:
            adam.state[p] = {"step": saved["moments"][name]["step"].clone(),
                             **{k: moments[k][name].to(p.device) for k in moments}}
    state.step = int(saved["step"])


# ---------------------------------------------------------------------------
# the rank's tasks
# ---------------------------------------------------------------------------

def _train_state(module, device, lr=1e-3, wd=1e-4, clip=1.0):
    from qat_vit_tpu_torch.train.steps import TrainState, data_parallel, make_optimizer

    module = module.to(device)
    return TrainState(module, make_optimizer(module.parameters(), lr, wd, clip),
                      replica=data_parallel(module))


def task_info(task, info, device) -> Dict[str, Any]:
    """The rank helpers in this world: ``get_dist_info``, a barrier, and
    the backend."""
    barrier("info")
    got = get_dist_info()
    return {"world_size": got.world_size, "rank": got.rank,
            "is_main_process": got.is_main_process,
            "global_device_count": got.global_device_count, "backend": dist.get_backend()}


def task_guard(task, info, device) -> Dict[str, Any]:
    """A QAT step whose activation observers lack the data axis must raise
    in a world > 1 (and take no collective before it does)."""
    from qat_vit_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step, \
        loss_hparams

    module = micro_vit(True, quant=micro_qconfig(axis=False)).module.to(device)
    state = TrainState(module, make_optimizer(module.parameters(), 1e-3, 1e-4))
    step = make_train_step(None, qat=True, image_size=32)
    try:
        step(state, to_device(micro_batch(MICRO_B, 0), device), loss_hparams(LOSS_HP, device))
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def _step_fn(detection: bool, qat: bool, observe: bool):
    from qat_vit_tpu_torch.train.detect_steps import make_detect_train_step
    from qat_vit_tpu_torch.train.steps import make_train_step

    make = make_detect_train_step if detection else make_train_step
    return make(None, qat=qat, image_size=32, observe=observe)


def _loss_hp(detection: bool, device):
    from qat_vit_tpu_torch.train.detect_steps import detect_loss_hparams
    from qat_vit_tpu_torch.train.steps import loss_hparams

    return (detect_loss_hparams if detection else loss_hparams)(LOSS_HP, device)


def task_steps(task, info, device) -> Dict[str, Any]:
    """Steps of given states: for each step ``i`` of each case the state is
    loaded from ``{dir}/{case}_state{i}.pt`` and steps on this rank's rows
    of ``{dir}/{case}_batch{i}.pt`` (each waited for: the caller may still
    be writing them); the state after it goes to
    ``{dir}/{case}_out{i}_rank{r}.pt`` with the metrics averaged over the
    ranks. A case: ``name``, ``detection``, ``qat``, ``observe`` (one flag a
    step), ``stride``, ``lr`` / ``wd`` / ``clip``."""
    d, timeout_s = task["dir"], float(task.get("wait_s", RANK_TIMEOUT_S))
    for case in task["cases"]:
        det, qat = case.get("detection", False), case["qat"]
        quant = micro_qconfig(stride=case.get("stride", 1)) if qat else None
        module = micro_detector(qat, quant=quant)[0] if det else micro_vit(qat, quant=quant).module
        state = _train_state(module, device, case["lr"], case["wd"], case["clip"])
        loss_hp = _loss_hp(det, device)
        for i, observe in enumerate(case["observe"]):
            state_path = os.path.join(d, f"{case['name']}_state{i}.pt")
            batch_path = os.path.join(d, f"{case['name']}_batch{i}.pt")
            for path in (state_path, batch_path):
                wait_for(path, timeout_s)
            load_state(state_path, state)
            batch = torch.load(batch_path, weights_only=True)
            shard = {k: v.to(device) for k, v in shard_of(batch, info.rank, info.world_size).items()}
            metrics = _step_fn(det, qat, observe)(state, shard, loss_hp)
            save_atomic({"module": state.module.state_dict(),
                         "metrics": {k: float(all_reduce_mean(v)) for k, v in metrics.items()}},
                        os.path.join(d, f"{case['name']}_out{i}_rank{info.rank}.pt"))
    return {"cases": [c["name"] for c in task["cases"]]}


def _micro_trainer(hp, device, data):
    from qat_vit_tpu_torch.train.trainer import KDQATTrainer

    return KDQATTrainer(hp, device=device, data=data, student=micro_vit(True),
                        teacher=micro_vit(False, seed=1))


def micro_trainer_hp(**over) -> Dict[str, Any]:
    """The micro trainers' hyperparameters: f32 steps, 32 px."""
    from qat_vit_tpu_torch.train.config import DEFAULT_HPARAMS

    hp = dict(DEFAULT_HPARAMS)
    hp.update(image_size=32, batch_size=MICRO_B, eval_batch_size=8, amp=False, qat_amp=False,
              lr=1e-3, weight_decay=1e-4, epochs=1)
    hp.update(over)
    return hp


def task_eval(task, info, device) -> Dict[str, Any]:
    """The sharded eval of a micro trainer: float, then (with the QAT
    student's state from ``task["state"]``, a ``steps`` output) fake-quant
    and int8; the top-1 of each and this rank's eval batches."""
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10

    data = synthetic_cifar10(n_train=16, n_test=task["n_test"], seed=3)
    t = _micro_trainer(micro_trainer_hp(), device, data)
    out = {"float": t.evaluate(), "float_batches": t.last_eval_batches}
    t.enable_qat()
    with torch.no_grad():
        t.student_qat.load_state_dict(torch.load(task["state"], weights_only=True)["module"])
    out.update(qat=t.evaluate(), qat_batches=t.last_eval_batches, int8=t.evaluate_int8())
    return out


def task_tp_steps(task, info, device) -> Dict[str, Any]:
    """Tensor-parallel steps of given states on the ``(data, model)`` rank
    grid of ``task``: for each case the whole state of
    ``{dir}/{case}_state0.pt`` (a :func:`save_state` file) is split for this
    rank and steps on its data shard of ``{dir}/{case}_batch0.pt`` (each
    waited for); rank 0 writes the gathered state dict, AdamW moments and
    first-block qkv weight gradient after it, with the metrics averaged
    over the ranks, to ``{dir}/{case}_tp{data}x{model}.pt``. Returns this
    rank's split parameters' and moments' shapes by case. A case: ``name``,
    ``qat``, ``lr`` / ``wd`` / ``clip``."""
    from qat_vit_tpu_torch.train.steps import TrainState, data_parallel, make_optimizer

    d, timeout_s = task["dir"], float(task.get("wait_s", RANK_TIMEOUT_S))
    mesh = make_mesh(data=task["data"], model=task["model"])
    out = {}
    for case in task["cases"]:
        qat = case["qat"]
        quant = micro_qconfig(model_axis=True) if qat else None
        module = shard_module(micro_vit(qat, quant=quant).module.to(device), mesh)
        state = TrainState(module, make_optimizer(module.parameters(), case["lr"], case["wd"],
                                                  case["clip"]), replica=data_parallel(module))
        paths = [os.path.join(d, f"{case['name']}_{k}0.pt") for k in ("state", "batch")]
        for path in paths:
            wait_for(path, timeout_s)
        load_state(paths[0], state, mesh)
        batch = torch.load(paths[1], weights_only=True)
        shard = {k: v.to(device) for k, v in shard_of(batch, mesh.data_index, mesh.data).items()}
        metrics = _step_fn(False, qat, True)(state, shard, _loss_hp(False, device))
        named = dict(module.named_parameters())
        adam = state.optimizer.adamw.state
        gathered = {
            "module": gather_params(module.state_dict(), module.cfg, mesh),
            "moments": {k: gather_params({n: adam[p][k] for n, p in named.items()}, module.cfg,
                                         mesh) for k in ("exp_avg", "exp_avg_sq")},
            "qkv_grad": gather_params({n: p.grad for n, p in named.items() if "qkv.weight" in n},
                                      module.cfg, mesh),
            "metrics": {k: float(all_reduce_mean(v)) for k, v in metrics.items()}}
        if info.rank == 0:
            save_atomic(gathered, os.path.join(
                d, f"{case['name']}_tp{task['data']}x{task['model']}.pt"))
        out[case["name"]] = dict(shard_shapes(module, state.optimizer),
                                 ranks_identical=ranks_identical(_flat(gathered["module"].values())))
    return out


def task_search(task, info, device) -> Dict[str, Any]:
    """The search driver on the micro ViT (``task["cfg"]``'s
    ``SearchConfig`` fields; ``{rank}`` in ``output_dir`` and
    ``mlflow_uri`` takes the rank) on synthetic data: its best value and
    parameters."""
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.search.driver import SearchConfig, run_optuna_search

    cfg = {k: v.format(rank=info.rank) if isinstance(v, str) else v
           for k, v in task["cfg"].items()}
    data = synthetic_cifar10(n_train=task["n_train"], n_test=task["n_test"], seed=2)
    res = run_optuna_search(SearchConfig(**cfg), data=data, prefer_optuna=False, device=device)
    return {"best_value": res["best_value"], "best_params": res["best_params"]}


def task_tp_gemm(task, info, device) -> Dict[str, Any]:
    """One bf16 layer of each split kind over a model axis of
    ``task["model"]`` ranks, from ``x`` ``[m, k]``, the whole f32 weight
    ``[n, k]`` and an output gradient ``[m, n]`` drawn from ``task["seed"]``:
    the row-parallel layer's product (this rank's input columns, summed over
    the ranks) and the column-parallel layer's input gradient (this rank's
    output rows, ``dx`` summed over the ranks). Rank 0 writes the inputs and
    both results to ``{dir}/tp_gemm.pt``."""
    from qat_vit_tpu_torch.models.vit import QuantDense
    from qat_vit_tpu_torch.parallel.tensor import COLUMN, ROW, share

    mesh = make_mesh(model=task["model"])
    m, k, n = task["m"], task["k"], task["n"]
    gen = torch.Generator().manual_seed(task["seed"])
    x = torch.randn(m, k, generator=gen).to(torch.bfloat16)
    w = 0.05 * torch.randn(n, k, generator=gen)
    dy = torch.randn(m, n, generator=gen).to(torch.bfloat16)

    def layer(kind, rows, cols):
        dense = QuantDense(cols.stop - cols.start, rows.stop - rows.start, None,
                           dtype=torch.bfloat16, use_bias=False)
        with torch.no_grad():
            dense.weight.copy_(w[rows, cols])
        dense.tp, dense.tp_group = kind, mesh.model_group
        return dense.to(device)

    lo, hi = share(k, mesh.model, mesh.model_index)
    row = layer(ROW, slice(0, n), slice(lo, hi))
    y_row = row.gemm(x[:, lo:hi].to(device))
    lo, hi = share(n, mesh.model, mesh.model_index)
    col = layer(COLUMN, slice(lo, hi), slice(0, k))
    xg = x.to(device, copy=True).requires_grad_(True)
    col.gemm(xg).backward(dy[:, lo:hi].to(device))
    if info.rank == 0:
        save_atomic({"x": x, "w": w, "dy": dy, "y_row": y_row.detach().cpu(),
                     "dx_col": xg.grad.cpu()}, os.path.join(task["dir"], "tp_gemm.pt"))
    return {}


def task_tp_dryrun(task, info, device) -> Dict[str, Any]:
    """The tensor-parallel dry run on the ``(world / model, model)`` grid:
    one float, one QAT and one QAT step under ``remat="dots"`` (the
    recomputed products re-enter the collectives) of the micro ViT against
    one process (:func:`tp_step_against_one_process`); raises on any miss."""
    mesh = make_mesh(model=task["model"])
    whole = to_device(micro_batch(MICRO_B * mesh.data, 0), device)
    readings = {}
    for name, qat, remat in (("float", False, "none"), ("qat", True, "none"),
                             ("qat_remat_dots", True, "dots")):
        quant = micro_qconfig(model_axis=True) if qat else None
        module = micro_vit(qat, quant=quant, remat=remat).module.to(device)
        readings[name] = r = tp_step_against_one_process(
            module, mesh, _step_fn(False, qat, True), whole, _loss_hp(False, device))
        if not (r["ranks_identical"] and r["loss_rel"] < 1e-4 and r["params_rel_l2"] < 1e-3
                and r["obs_rel"] < 1e-6 and r["weight_obs_equal"]):
            raise RuntimeError(f"dryrun: the {name} TP step against one process: {r}")
    return readings


def task_train_main(task, info, device) -> Dict[str, Any]:
    """``train_main`` (or ``detect_train_main``) on micro models and
    synthetic data; ``{rank}`` in ``output_dir`` takes the rank, so each
    rank's writes land apart. Returns each epoch's results."""
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.train import trainer as tr

    hp = dict(task["hp"], output_dir=task["hp"]["output_dir"].format(rank=info.rank))
    data = synthetic_cifar10(n_train=task["n_train"], n_test=task["n_test"], seed=1)
    result = tr.train_main(hp, device=device, data=data, student=micro_vit(True),
                           teacher=micro_vit(False, seed=1))
    return {"results": [dataclasses.asdict(r) for r in result["results"]],
            "final_quant_acc": result["final_quant_acc"]}


def task_dryrun(task, info, device) -> Dict[str, Any]:
    """The dry run: float, observing QAT and frozen QAT DP steps of the
    micro ViT, and an observing QAT step with the qkv fake-quant inside the
    attention kernels, against one process; the sharded eval, the predictor
    with a replica per device, one detection QAT DP step; raises on any
    miss."""
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.serve.predictor import Int8Predictor

    world = info.world_size
    whole = to_device(micro_batch(MICRO_B * world, 0), device)
    shard = shard_of(whole, info.rank, world)
    readings = {}
    float_state = _train_state(micro_vit(False).module, device)
    readings["float"] = step_against_one_process(float_state, _step_fn(False, False, True),
                                                 shard, whole, _loss_hp(False, device))
    qat = micro_vit(True).module
    qat.load_state_dict(float_state.module.state_dict(), strict=False)
    qat_state = _train_state(qat, device)
    readings["qat"] = step_against_one_process(qat_state, _step_fn(False, True, True), shard,
                                               whole, _loss_hp(False, device))
    readings["frozen"] = step_against_one_process(qat_state, _step_fn(False, True, False),
                                                  shard, whole, _loss_hp(False, device))
    # the qkv fake-quant inside the attention (kernel A's in_fq) reads the
    # observer after its reduction over the ranks: the global qparams
    from qat_vit_tpu_torch.models.vit import attention_train_available

    fq = micro_vit(True, fast_math=True, fq_in_kernel=True).module
    cfg = fq.cfg
    if not attention_train_available(cfg.num_heads, cfg.head_dim, cfg.seq_len, cfg.dtype):
        raise RuntimeError("dryrun: the micro ViT does not take the attention kernels")
    fq.load_state_dict(float_state.module.state_dict(), strict=False)
    readings["qat_fq_in_kernel"] = step_against_one_process(
        _train_state(fq, device), _step_fn(False, True, True), shard, whole,
        _loss_hp(False, device))
    for name, r in readings.items():
        if not (r["ranks_identical"] and r["loss_rel"] < 1e-4 and r["params_rel_l2"] < 1e-3
                and r["obs_rel"] < 1e-6):
            raise RuntimeError(f"dryrun: the {name} DP step against one process: {r}")

    data = synthetic_cifar10(n_train=16, n_test=2 * 8 * world + 1, seed=3)
    t = _micro_trainer(micro_trainer_hp(), device, data)
    t.enable_qat()
    with torch.no_grad():
        t.student_qat.load_state_dict(qat_state.module.state_dict())
    acc = t.evaluate()
    one = sum(int(t.eval_step(t.student_qat, to_device(
        {"image": data["test_images"][s:s + 8], "label": data["test_labels"][s:s + 8]
         .astype(np.int64)}, device))) for s in range(0, len(data["test_labels"]), 8))
    if round(acc * len(data["test_labels"])) != one:
        raise RuntimeError(f"dryrun: sharded eval {acc} against {one} correct in one process")
    export = t.convert_int8()
    images = data["test_images"][:8]
    single = Int8Predictor(export, t.student_qat_cfg, batch_size=8, device=device).logits(images)
    mesh = make_mesh(devices=[device, device])
    dp = Int8Predictor(export, t.student_qat_cfg, batch_size=8, mesh=mesh).logits(images)
    if not np.array_equal(single, dp):
        raise RuntimeError("dryrun: the mesh predictor's logits differ from one device's")

    det_whole = to_device(micro_batch(MICRO_B * world, 1, detection=True), device)
    det_state = _train_state(micro_detector(True)[0], device)
    readings["detection"] = step_against_one_process(
        det_state, _step_fn(True, True, True), shard_of(det_whole, info.rank, world), det_whole,
        _loss_hp(True, device))
    r = readings["detection"]
    if not (r["ranks_identical"] and r["loss_rel"] < 1e-4 and r["obs_rel"] < 1e-6):
        raise RuntimeError(f"dryrun: the detection DP step against one process: {r}")
    readings["eval_acc"] = acc
    return readings


TASKS = {"info": task_info, "guard": task_guard, "steps": task_steps, "eval": task_eval,
         "train_main": task_train_main, "dryrun": task_dryrun, "tp_steps": task_tp_steps,
         "search": task_search, "tp_dryrun": task_tp_dryrun, "tp_gemm": task_tp_gemm}


def run_job(job: Dict[str, Any]) -> None:
    """A rank's side: join the world, run ``job["tasks"]`` in order, write
    ``{out}/rank{r}.json`` (each task's results by its ``name``, else its
    kind), leave the world."""
    device = job.get("device", "cuda")
    if torch.device(device).type == "cpu":
        # several ranks beside the caller on a shared host
        torch.set_num_threads(int(job.get("threads", 2)))
    info, device = setup_distributed(device, timeout_s=float(job.get("timeout_s",
                                                                     RANK_TIMEOUT_S)))
    try:
        results = {}
        for task in job["tasks"]:
            results[task.get("name", task["kind"])] = TASKS[task["kind"]](task, info, device)
        barrier("job_end")
        with open(os.path.join(job["out"], f"rank{info.rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        cleanup_distributed()


def run_ranks(job: Dict[str, Any], n_processes: int, *,
              timeout_s: float = RANK_TIMEOUT_S) -> List[Dict[str, Any]]:
    """Run ``job`` on ``n_processes`` ranks (:func:`launch`); each rank's
    results, by rank."""
    os.makedirs(job["out"], exist_ok=True)
    path = os.path.join(job["out"], "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    launch(["-m", "qat_vit_tpu_torch.parallel.dryrun", "--job", path], n_processes, job["out"],
           timeout_s=timeout_s)
    out = []
    for rank in range(n_processes):
        with open(os.path.join(job["out"], f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def dryrun_multichip(n_processes: int = 2, device="cuda",
                     timeout_s: float = RANK_TIMEOUT_S, model: int = 1) -> Dict[str, Any]:
    """The dry run on ``n_processes`` ranks (on CUDA they share the cards
    round-robin), data-parallel, or with ``model`` > 1 tensor-parallel on
    the ``(n_processes / model, model)`` rank grid; prints one OK line and
    returns rank 0's readings. The kernels are built here first, so that
    the ranks load one library."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device; pass device='cpu'")
        from qat_vit_tpu_torch import _build

        _build.build()
    t0 = time.perf_counter()
    if model > 1:
        with tempfile.TemporaryDirectory(prefix="qvt_dryrun_") as out:
            results = run_ranks({"device": str(device), "out": out, "timeout_s": timeout_s,
                                 "tasks": [{"kind": "info"},
                                           {"kind": "tp_dryrun", "model": model}]},
                                n_processes, timeout_s=timeout_s)
        info, r = results[0]["info"], results[0]["tp_dryrun"]
        steps = ("float", "qat", "qat_remat_dots")
        print(f"dryrun_multichip OK: {n_processes} ranks on {info['backend']} ({device}), a "
              f"{n_processes // model}x{model} rank grid; {' / '.join(steps)} TP steps against "
              "one process, loss rel " + " / ".join(f"{r[k]['loss_rel']:.2e}" for k in steps)
              + ", params rel L2 " + " / ".join(f"{r[k]['params_rel_l2']:.2e}" for k in steps)
              + f", weight observers identical; {time.perf_counter() - t0:.1f} s", flush=True)
        return r
    with tempfile.TemporaryDirectory(prefix="qvt_dryrun_") as out:
        results = run_ranks({"device": str(device), "out": out, "timeout_s": timeout_s,
                             "tasks": [{"kind": "info"}, {"kind": "dryrun"}]},
                            n_processes, timeout_s=timeout_s)
    info, r = results[0]["info"], results[0]["dryrun"]
    steps = ("float", "qat", "frozen", "qat_fq_in_kernel", "detection")
    print(f"dryrun_multichip OK: {n_processes} ranks on {info['backend']} ({device}); "
          f"{' / '.join(steps)} DP steps against one process, loss rel "
          + " / ".join(f"{r[k]['loss_rel']:.2e}" for k in steps) + ", params rel L2 "
          + " / ".join(f"{r[k]['params_rel_l2']:.2e}" for k in steps)
          + f"; sharded eval top-1 {r['eval_acc']:.4f}; mesh predictor identical; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return r


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_processes", nargs="?", type=int, default=2)
    parser.add_argument("--model", type=int, default=1, help="the model axis (tensor parallel)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--job", help="run one rank of a job file (set by launch)")
    args = parser.parse_args(argv)
    if args.job:
        with open(args.job) as f:
            run_job(json.load(f))
        return
    dryrun_multichip(args.n_processes, args.device, model=args.model)


if __name__ == "__main__":
    main()
