"""Data and tensor parallelism over ``torch.distributed`` ranks (port of
``qat_vit_tpu/parallel/mesh.py``): one process per rank, one device per
process, launched by ``torchrun`` (``python -m torch.distributed.run``), as
the reference's DDP was.

- :func:`setup_distributed` reads torchrun's environment, picks this rank's
  device and joins the process group: ``nccl`` when each rank has a card of
  its own, ``gloo`` when ranks share a card (NCCL refuses two ranks on one
  GPU) and on the CPU. A failed init raises; nothing falls back.
- :func:`get_dist_info`, :func:`barrier`: the rank helpers, for any world
  (with no process group: rank 0 of 1, ``barrier`` free).
- :func:`all_reduce_minmax`: the observers' ``pmin`` / ``pmax``, exact (one
  ``MIN`` all-reduce of ``[min, -max]``); it, :func:`all_reduce_sum` and
  :func:`all_reduce_mean` take a ``group`` (default: every rank).
- :func:`make_mesh`: in a process group (or with ``model > 1``) the
  ``(data, model)`` rank grid over the world, as JAX's ``reshape(data,
  model)`` lays out its devices: rank ``r`` has data index ``r // model``
  and model index ``r % model``, and the mesh carries the process groups of
  its data and model axes (``parallel/tensor.py`` splits the model over the
  latter). Given ``devices``, the devices of a data-parallel
  ``Int8Predictor`` in one process (a replica per device).

The GSPMD sharding helpers of the JAX module (``logical_sharding``,
``batch_sharding``, ``replicated_sharding``, ``shard_batch``) have no
counterpart: each rank holds its own batch shard, and its model index picks
its shard of the split weights (``parallel/tensor.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# seconds a collective (init included) may wait for the other ranks before
# it raises: a lost rank ends the run instead of hanging it
DEFAULT_TIMEOUT_S = 600.0

@dataclasses.dataclass(frozen=True)
class DistInfo:
    """Rank info, the surface of the reference's ``DDPInfo``: one device per
    process, so ``global_device_count`` is the world size."""

    world_size: int
    rank: int
    local_device_count: int
    global_device_count: int

    @property
    def is_main_process(self) -> bool:
        return self.rank == 0


def is_distributed() -> bool:
    """Whether this process belongs to an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def get_dist_info() -> DistInfo:
    """This rank's place in the world: rank 0 of 1 with no process group."""
    if not is_distributed():
        return DistInfo(world_size=1, rank=0, local_device_count=1, global_device_count=1)
    world = dist.get_world_size()
    return DistInfo(world_size=world, rank=dist.get_rank(), local_device_count=1,
                    global_device_count=world)


def is_main_process() -> bool:
    return get_dist_info().is_main_process


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def setup_distributed(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S
                      ) -> Tuple[DistInfo, torch.device]:
    """Join torchrun's process group (the reference's ``setup_ddp``) and
    return ``(info, this rank's device)``.

    Reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``. Without ``WORLD_SIZE`` (not under
    torchrun) this is a world of one with no process group, on ``device``
    as given.
    On CUDA the rank takes ``cuda:(LOCAL_RANK % device_count)`` and the
    backend follows from the layout: ``nccl`` when each local rank has a
    card of its own, ``gloo`` when ranks share one; on the CPU ``gloo``."""
    world = _env_int("WORLD_SIZE")
    if world is None:
        return get_dist_info(), device
    device = torch.device(device)
    if is_distributed():
        raise RuntimeError("setup_distributed: this process already joined a process group")
    rank, local_rank = _env_int("RANK") or 0, _env_int("LOCAL_RANK") or 0
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    kwargs = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("setup_distributed: no CUDA device; pass device='cpu' for the CPU")
        n_cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
        backend = "nccl" if local_world <= n_cards else "gloo"
        if backend == "nccl":
            kwargs["device_id"] = device
    else:
        backend = "gloo"
    print(f"rank {rank}/{world}: process group on {backend} "
          f"({os.environ.get('MASTER_ADDR', '?')}:{os.environ.get('MASTER_PORT', '?')}), "
          f"device {device}", flush=True)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return get_dist_info(), device


def cleanup_distributed() -> None:
    """Leave the process group (the reference's ``cleanup_ddp``); the rank
    grids made in it go with it."""
    _RANK_MESHES.clear()
    if is_distributed():
        dist.destroy_process_group()


def pick_free_port() -> int:
    """A free TCP port on this host, for a ``MASTER_PORT`` of a launch
    made by hand."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def barrier(name: str = "barrier") -> None:
    """Every rank waits here for the others (the reference's
    ``dist.barrier``); free with no process group."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def group_size(group=None) -> int:
    """The ranks of ``group`` (default: every rank); 1 with no process group."""
    return dist.get_world_size(group) if is_distributed() else 1


def all_reduce_minmax(batch_min: torch.Tensor, batch_max: torch.Tensor, group=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pmin(batch_min), pmax(batch_max))`` over the ranks of ``group``
    (default: every rank): one ``MIN`` all-reduce of ``[min, -max]``. Exact:
    min and max are order statistics, and negation is exact. Identity in a
    group of one."""
    if group_size(group) == 1:
        return batch_min, batch_max
    pair = torch.stack([batch_min, -batch_max])
    dist.all_reduce(pair, op=dist.ReduceOp.MIN, group=group)
    return pair[0], -pair[1]


def all_reduce_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``group`` (default: every rank; a
    new tensor, ``t`` itself in a group of one)."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t / n


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (default: every rank; a
    new tensor, ``t`` itself in a group of one)."""
    if group_size(group) == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` mesh: the rank grid of a process group, or the
    devices of a data-parallel predictor in one process (``devices``, along
    the data axis; ``model`` 1).

    In the rank grid this rank sits at ``(data_index, model_index)``;
    ``data_group`` holds the ranks of its model index (the ranks whose
    gradients DDP averages), ``model_group`` those of its data index (the
    ranks that split one replica). With ``model`` 1 ``data_group`` is None,
    the default group (every rank), and ``model_group`` None (each rank its
    own)."""

    devices: Tuple[torch.device, ...] = ()
    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None


# the rank grids with a model axis made in this process group, by shape,
# beside the group they were made in: each trainer of a search builds its
# mesh, and new groups for every one would open new connections each time
_RANK_MESHES: Dict[Tuple[int, int], Tuple[Any, Mesh]] = {}


def _rank_mesh(data: Optional[int], model: int) -> Mesh:
    n = world_size()
    if model < 1:
        raise ValueError(f"model={model} < 1")
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    rank = get_dist_info().rank
    where = dict(data=data, model=model, data_index=rank // model, model_index=rank % model)
    if model == 1:
        return Mesh(**where)
    world = dist.group.WORLD
    cached = _RANK_MESHES.get((data, model))
    if cached is None or cached[0] is not world:
        groups = {}
        # every rank calls new_group for every group, in this order
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == where["data_index"]:
                groups["model_group"] = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == where["model_index"]:
                groups["data_group"] = g
        _RANK_MESHES[data, model] = world, Mesh(**where, **groups)
    return _RANK_MESHES[data, model][1]


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, model)`` mesh.

    Without ``devices``, in a process group or with ``model > 1``: the rank
    grid over the world (:class:`Mesh`), ``data`` defaulting to ``world //
    model``; ``data * model`` other than the world raises ``ValueError``, as
    JAX's mesh does over its devices (a world of one without a process group
    is one device). Every rank must call it: the groups of a model axis come
    from ``dist.new_group``.

    Otherwise a ``(data, 1)`` mesh over ``devices`` (default: every CUDA
    device of this process), the replicas of a data-parallel predictor; a
    device may appear more than once. ``model > 1`` there raises: a model
    axis splits the model over ranks."""
    if devices is None and (model != 1 or is_distributed()):
        return _rank_mesh(data, model)
    if model != 1:
        raise ValueError(f"a device list is a data axis (model={model}): tensor "
                         "parallelism runs one rank per device")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] for the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if data is not None and data != len(devices):
        raise ValueError(f"mesh {data}x{model} != {len(devices)} devices")
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(devices, data=len(devices))
