"""Distributed-runtime info (the rank helpers of
``qat_vit_tpu/parallel/mesh.py``) on ``torch.distributed``.

One process on one device: with no process group, or a world of one, this
process is rank 0 of 1 and :func:`barrier` returns at once. A larger world
raises: data parallelism (DDP, the observers' all-reduce, per-rank shards)
is ROADMAP.md Queue 1, item 5.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

_ITEM_5 = ("a world of {} processes is not ported yet: data parallelism is "
           "ROADMAP.md Queue 1, item 5")


@dataclasses.dataclass(frozen=True)
class DistInfo:
    """Rank info, the surface of the reference's ``DDPInfo``."""

    world_size: int
    rank: int
    local_device_count: int
    global_device_count: int

    @property
    def is_main_process(self) -> bool:
        return self.rank == 0


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def get_dist_info() -> DistInfo:
    """Rank 0 of a world of 1, on one device; a larger initialized world
    raises ``NotImplementedError``."""
    world = _world_size()
    if world > 1:
        raise NotImplementedError(_ITEM_5.format(world))
    return DistInfo(world_size=1, rank=0, local_device_count=1, global_device_count=1)


def is_main_process() -> bool:
    return get_dist_info().is_main_process


def barrier(name: str = "barrier") -> None:
    """The reference's ``dist.barrier``: free in a world of one."""
    world = _world_size()
    if world > 1:
        raise NotImplementedError(f"barrier {name!r}: " + _ITEM_5.format(world))
