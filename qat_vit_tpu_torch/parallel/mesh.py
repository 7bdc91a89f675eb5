"""Data parallelism over ``torch.distributed`` ranks (port of
``qat_vit_tpu/parallel/mesh.py``): one process per rank, one device per
process, launched by ``torchrun`` (``python -m torch.distributed.run``), as
the reference's DDP was.

- :func:`setup_distributed` reads torchrun's environment, picks this rank's
  device and joins the process group: ``nccl`` when each rank has a card of
  its own, ``gloo`` when ranks share a card (NCCL refuses two ranks on one
  GPU) and on the CPU. A failed init raises; nothing falls back.
- :func:`get_dist_info`, :func:`barrier`: the rank helpers, for any world
  (with no process group: rank 0 of 1, ``barrier`` free).
- :func:`all_reduce_minmax`: the activation observers' ``pmin`` / ``pmax``
  over the data axis, exact (one ``MIN`` all-reduce of ``[min, -max]``).
- :func:`make_mesh`: the devices of a data-parallel ``Int8Predictor`` in one
  process (a replica per device). A ``model`` axis (tensor parallelism) is
  ROADMAP.md Queue 1, item 11, and raises.

The GSPMD sharding helpers of the JAX module (``logical_sharding``,
``batch_sharding``, ``replicated_sharding``, ``shard_batch``) have no
counterpart: each rank holds its own batch shard and a whole replica.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# seconds a collective (init included) may wait for the other ranks before
# it raises: a lost rank ends the run instead of hanging it
DEFAULT_TIMEOUT_S = 600.0

_ITEM_11 = "tensor parallelism (a model axis > 1) is not ported yet: ROADMAP.md Queue 1, item 11"


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
    """Leave the process group (the reference's ``cleanup_ddp``)."""
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


def all_reduce_minmax(batch_min: torch.Tensor, batch_max: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pmin(batch_min), pmax(batch_max))`` over every rank: one ``MIN``
    all-reduce of ``[min, -max]``. Exact: min and max are order statistics,
    and negation is exact. Identity in a world of one."""
    if world_size() == 1:
        return batch_min, batch_max
    pair = torch.stack([batch_min, -batch_max])
    dist.all_reduce(pair, op=dist.ReduceOp.MIN)
    return pair[0], -pair[1]


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over every rank (a new tensor; ``t`` itself when
    the world is one)."""
    if world_size() == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t / dist.get_world_size()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank (a new tensor; ``t`` itself when the
    world is one)."""
    if world_size() == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a data-parallel predictor in one process, along the
    data axis."""

    devices: Tuple[torch.device, ...]


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, 1)`` mesh over ``devices`` (default: every CUDA device of
    this process). A device may appear more than once: each entry holds a
    replica. ``model > 1`` raises (ROADMAP.md Queue 1, item 11)."""
    if model != 1:
        raise NotImplementedError(_ITEM_11)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] for the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if data is not None and data != len(devices):
        raise ValueError(f"mesh {data}x{model} != {len(devices)} devices")
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(devices)
