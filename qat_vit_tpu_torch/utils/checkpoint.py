"""Checkpoint save/load for parameter, observer and int8-export trees (port of
``qat_vit_tpu/utils/checkpoint.py``).

The files are the JAX package's: flax's msgpack of the tree
(:mod:`qat_vit_tpu_torch.utils.msgpack_codec`, byte for byte) plus a JSON
sidecar of metadata, so either package reads what the other writes. Every leaf
is written as an array (a Python float as a 0-d float64 array, as the JAX
package's ``np.asarray`` makes it; a torch tensor from the host), and dict keys
in sorted order, as ``jax.tree.map`` rebuilds them; lists are keyed ``"0"``,
``"1"``, ... Orbax, the JAX package's opt-in backend, is not ported.

Loading keeps the reference's defensive tolerance: :func:`tolerant_merge`
restores against a structure template and reports, rather than crashes on,
missing or unexpected leaves.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from qat_vit_tpu_torch.utils.msgpack_codec import packb, unpackb

logger = logging.getLogger(__name__)


def _to_numpy(tree):
    """The tree as ``jax.tree.map(np.asarray, tree)`` gives it: dicts with sorted
    keys, lists and tuples kept, None kept, every other leaf an array (a bf16
    tensor, which numpy cannot hold, as a host tensor)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, tree: Dict[str, Any], metadata: Optional[dict] = None) -> str:
    """Serialize a tree (params / quant_stats / int8 export) to msgpack.

    Both files are published atomically (tmp + os.replace), the msgpack
    first. The JSON sidecar is advisory: no ordering of two files can make
    the pair crash-atomic, so any state a loader depends on must live as
    leaves inside the msgpack tree itself; the sidecar exists for humans and
    tools."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    data = packb(_to_numpy(tree))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)  # atomic publish
    if metadata is not None:
        meta_tmp = path + ".json.tmp"
        with open(meta_tmp, "w") as f:
            json.dump(metadata, f, indent=2, default=str)
        os.replace(meta_tmp, path + ".json")
    logger.info("wrote %s (%d bytes)", path, len(data))
    return path


def _restore(template, state, path=()):
    """flax's ``from_state_dict``: the template's structure (dicts in its key
    order, lists, tuples) with the restored leaves."""
    if isinstance(template, dict):
        missing = {str(k) for k in template} - set(state)
        if missing:
            raise ValueError(f"the target dict keys {missing} are not in the checkpoint at "
                             f"{'/'.join(path) or '.'}")
        return {k: _restore(v, state[str(k)], path + (str(k),)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(state) != len(template):
            raise ValueError(f"the list at {'/'.join(path) or '.'} has {len(template)} items, "
                             f"the checkpoint {len(state)}")
        return type(template)(_restore(v, state[str(i)], path + (str(i),))
                              for i, v in enumerate(template))
    return state


def load_checkpoint(path: str, template: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Restore a tree. With a ``template`` the result has the template's exact
    structure; without, returns raw nested dicts. Leaves are numpy arrays
    (numpy scalars where the writer gave one; a ``bfloat16`` leaf as a
    ``torch.bfloat16`` tensor)."""
    with open(path, "rb") as f:
        data = f.read()
    state = unpackb(data)
    return _restore(template, state) if template is not None else state


def _like(rest, tmpl):
    """The restored leaf ``rest`` as ``tmpl``'s array type and dtype, or None
    where the shapes differ."""
    if isinstance(tmpl, torch.Tensor):
        t = rest if isinstance(rest, torch.Tensor) else torch.from_numpy(np.array(rest))
        return t.to(tmpl.dtype) if tuple(t.shape) == tuple(tmpl.shape) else None
    if isinstance(rest, torch.Tensor):
        rest = rest.float().numpy()
    arr, want = np.asarray(rest), np.asarray(tmpl)
    return arr.astype(want.dtype) if arr.shape == want.shape else None


def tolerant_merge(template: Dict[str, Any],
                   restored: Dict[str, Any]) -> Tuple[Dict[str, Any], list, list]:
    """``strict=False``-style restore (the reference's defensive loaders):
    overwrite template leaves that exist in ``restored``, keep template
    values for missing keys, ignore unexpected keys. Returns (merged,
    missing_paths, unexpected_paths)."""
    missing: list = []
    unexpected: list = []

    def walk(tmpl, rest, path):
        if isinstance(tmpl, dict):
            rest = rest if isinstance(rest, dict) else {}
            for k in rest:
                if k not in tmpl:
                    unexpected.append(path + (k,))
            return {k: walk(v, rest.get(k, _MISSING), path + (k,)) for k, v in tmpl.items()}
        if rest is _MISSING:
            missing.append(path)
            return tmpl
        leaf = _like(rest, tmpl)
        if leaf is None:
            missing.append(path)  # shape mismatch → treated as missing
            return tmpl
        return leaf

    merged = walk(template, restored, ())
    if missing:
        logger.warning("checkpoint missing %d leaves (kept template values)", len(missing))
    if unexpected:
        logger.warning("checkpoint has %d unexpected leaves (ignored)", len(unexpected))
    return merged, missing, unexpected


class _Missing:
    pass


_MISSING = _Missing()


def load_metadata(path: str) -> dict:
    meta_path = path + ".json"
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


class BestCheckpointer:
    """Best-model selection with the reference's rule: save when the epoch's
    accuracy improves on the best so far."""

    def __init__(self, output_dir: str, name: str = "best_qat"):
        self.output_dir = output_dir
        self.name = name
        self.best_metric = float("-inf")
        self.best_path: Optional[str] = None

    def maybe_save(self, metric: float, tree: Dict[str, Any],
                   metadata: Optional[dict] = None) -> Tuple[bool, Optional[str]]:
        if metric <= self.best_metric:
            return False, self.best_path
        self.best_metric = metric
        meta = dict(metadata or {})
        meta["metric"] = metric
        path = os.path.join(self.output_dir, f"{self.name}.msgpack")
        self.best_path = save_checkpoint(path, tree, meta)
        logger.info("saved %s (metric=%.4f)", path, metric)
        return True, self.best_path
