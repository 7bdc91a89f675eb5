"""Parallelism: data and tensor parallelism over ``torch.distributed`` ranks,
the rank helpers and the ``(data, model)`` rank grid (``parallel/mesh.py``),
the split of the model over the model axis (``parallel/tensor.py``), and the
devices of a data-parallel predictor."""

from qat_vit_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    DistInfo,
    Mesh,
    all_reduce_mean,
    all_reduce_minmax,
    all_reduce_sum,
    barrier,
    cleanup_distributed,
    get_dist_info,
    is_distributed,
    is_main_process,
    make_mesh,
    pick_free_port,
    setup_distributed,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "DistInfo",
    "Mesh",
    "all_reduce_mean",
    "all_reduce_minmax",
    "all_reduce_sum",
    "barrier",
    "cleanup_distributed",
    "get_dist_info",
    "is_distributed",
    "is_main_process",
    "make_mesh",
    "pick_free_port",
    "setup_distributed",
]
