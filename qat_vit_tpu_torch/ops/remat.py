"""Per-block rematerialization (``ViTConfig.remat``; port of the JAX
module's ``nn.remat`` blocks, ``qat_vit_tpu/models/vit.py:487-510``).

:func:`recompute` runs a function under ``torch.utils.checkpoint``
(non-reentrant): its forward keeps only the function's inputs, and the
backward runs the function again to get back what the forward did not keep.

- ``"full"``: a block is one such function; the backward recomputes the
  whole block from its input, the training attention kernel's forward
  included.
- ``"dots"``: a block is split by hand (``models/vit.Block.forward_dots``)
  into functions that each end at a GEMM's product, and the attention runs
  outside every one of them. So the backward keeps the products, the
  attention's input and output and the residual stream, and recomputes the
  elementwise chains in front of each product (LayerNorm, GELU, fake-quant,
  bias adds). The recompute stops once a product's own inputs are back
  (``set_checkpoint_early_stop``: a GEMM saves its inputs before it runs),
  so no GEMM runs twice; the attention kernel runs once.

The recompute must not observe again: :func:`recompute` passes
``observe=REPLAY`` to the second run of an observing function, and a
fake-quant site given it fake-quantizes from the statistics the first run
stored and updates nothing (no second EMA step, no second all-reduce under
data parallelism). So loss, gradients and observers are those of ``"none"``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import checkpoint as _checkpoint

from qat_vit_tpu_torch.quant.modules import REPLAY

REMAT_MODES = ("none", "dots", "full")


def recompute(fn: Callable[..., Any], *args: torch.Tensor, observe=False) -> Any:
    """``fn(*args, observe=observe)``, its intermediates recomputed in the
    backward (a non-reentrant checkpoint that stops recomputing once every
    tensor the backward reads is back); the recompute gets
    ``observe=REPLAY`` where the forward observed."""
    runs = []

    def run(*inp):
        again = bool(runs)  # the first run is the forward, a later one the recompute
        runs.append(again)
        return fn(*inp, observe=REPLAY if again and observe else observe)

    with _checkpoint.set_checkpoint_early_stop(True):
        return _checkpoint.checkpoint(run, *args, use_reentrant=False,
                                      preserve_rng_state=False)
