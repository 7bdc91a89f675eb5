"""Parallelism: the distributed-runtime info of one process (data
parallelism is ROADMAP.md Queue 1, item 5)."""

from qat_vit_tpu_torch.parallel.mesh import DistInfo, barrier, get_dist_info, is_main_process

__all__ = ["DistInfo", "barrier", "get_dist_info", "is_main_process"]
