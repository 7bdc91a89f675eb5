"""Weights and observer state carried across from the JAX package.

Takes nested dicts of numpy arrays, as ``jax.device_get`` gives the JAX
package's ``params`` and ``quant_stats`` trees (and its ``convert_vit``
export), and never imports JAX:

- :func:`params_to_state_dict`: JAX ``params`` → this package's
  ``VisionTransformer`` or ``Owlv2Detector`` parameters (dense kernels
  ``[K, N]`` become ``nn.Linear``-style ``weight [N, K]``; LayerNorm
  ``scale`` → ``weight``; a detector's tower sits under ``vision``, its
  ``norm_pre`` like any LayerNorm); :func:`state_dict_to_params`, the
  inverse (the tree the JAX package's checkpoints and converters hold);
- :func:`quant_stats_to_buffers` / :func:`buffers_to_quant_stats`: the
  ``quant_stats`` tree ↔ the observer buffers (``...min_val``/``...max_val``);
- :func:`export_from_numpy`: a ``convert_vit`` tree → the same tree of torch
  tensors (``str(i)`` block keys, ``w_int8 [K, N]``);
  :func:`detector_export_from_numpy`: a ``convert_detector`` export (int8
  tower + float head params) → the port's.

Module paths map as ``blocks_{i}`` ↔ ``blocks.{i}``; every other name is the
same in both packages.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = k.replace("blocks_", "blocks.") if k.startswith("blocks_") else k
        name = f"{prefix}.{key}" if prefix else key
        if hasattr(v, "items"):
            out.update(_flatten(dict(v), name))
        else:
            out[name] = v
    return out


def _f32(v) -> torch.Tensor:
    """A leaf as an f32 CPU tensor (a bf16 leaf, which the msgpack reader
    gives as a torch tensor, included)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().to(torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32))


def params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``params`` tree → parameter entries of the port's ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for name, v in _flatten(params).items():
        t = _f32(v)
        if name.endswith(".kernel"):
            sd[name[: -len("kernel")] + "weight"] = t.T.contiguous()
        elif name.endswith(".scale"):  # LayerNorm (the tower's .ln, merged_ln)
            sd[name[: -len("scale")] + "weight"] = t
        else:
            sd[name] = t
    return sd


def state_dict_to_params(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The parameters of a port ``state_dict`` (observer buffers skipped) →
    the JAX ``params`` tree of numpy f32 arrays: ``weight [N, K]`` of a
    linear layer → ``kernel [K, N]``, a LayerNorm's 1-d ``weight`` →
    ``scale``, ``blocks.{i}`` → ``blocks_{i}``."""
    tree: Dict[str, Any] = {}
    for name, v in sd.items():
        if name.endswith((".min_val", ".max_val")):
            continue
        a = v.detach().cpu().to(torch.float32).numpy()
        path = re.sub(r"\bblocks\.(\d+)", r"blocks_\1", name).split(".")
        if path[-1] == "weight":
            path[-1], a = ("kernel", np.ascontiguousarray(a.T)) if a.ndim == 2 else ("scale", a)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a
    return tree


def quant_stats_to_buffers(quant_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``quant_stats`` tree → observer buffer entries of the ``state_dict``."""
    return {name: _f32(v).reshape(()) for name, v in _flatten(quant_stats).items()}


def buffers_to_quant_stats(buffers: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Observer buffers (any ``state_dict`` holding them) → the JAX
    ``quant_stats`` tree of numpy f32 scalars."""
    tree: Dict[str, Any] = {}
    for name, v in buffers.items():
        if not (name.endswith(".min_val") or name.endswith(".max_val")):
            continue
        path = re.sub(r"\bblocks\.(\d+)", r"blocks_\1", name).split(".")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(v.detach().cpu(), dtype=np.float32)
    return tree


def load_jax_variables(module: torch.nn.Module, params: Dict[str, Any],
                       quant_stats: Dict[str, Any] = None) -> torch.nn.Module:
    """Load JAX ``params`` (and ``quant_stats`` when given) into ``module``
    in place; every parameter must be covered."""
    sd = params_to_state_dict(params)
    if quant_stats is not None:
        sd.update(quant_stats_to_buffers(quant_stats))
    missing, unexpected = module.load_state_dict(sd, strict=False)
    missing = [m for m in missing if not m.endswith(("min_val", "max_val"))]
    if missing or unexpected:
        raise ValueError(f"JAX tree does not match the module: missing {missing}, "
                         f"unexpected {unexpected}")
    return module


def export_from_numpy(tree: Any) -> Any:
    """A ``convert_vit`` export of numpy arrays → the same tree of CPU
    tensors (integer arrays keep their dtype; floats become f32)."""
    if hasattr(tree, "items"):
        return {k: export_from_numpy(v) for k, v in dict(tree).items()}
    if tree is None:
        return None
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


def detector_export_from_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX ``convert_detector`` export → the port's: the tower as
    :func:`export_from_numpy` gives it, the heads as ``Owlv2Detector``
    parameters."""
    return {"tower": export_from_numpy(tree["tower"]),
            "heads": params_to_state_dict(tree["heads"])}
