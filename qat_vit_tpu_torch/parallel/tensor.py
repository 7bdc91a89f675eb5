"""Tensor parallelism: the ViT split over the model axis of a rank grid
(``parallel/mesh.py``), along the axis the JAX module annotates ``hidden``
(``qat_vit_tpu/models/vit.py``: the qkv and fc1 kernels are ``(embed,
hidden)``, proj and fc2 ``(hidden, embed)``; everything else replicated).

- **The layout.** Heads go to the model ranks as contiguous groups, the
  first ``H % k`` ranks one more (``np.array_split``'s rule: ViT-S's 6 heads
  over 4 ranks are 2, 2, 1, 1); the MLP width is split by the same rule.
  qkv's output rows are ordered ``(3, H, hd)``, so a rank's qkv rows are
  its heads' rows in each of q, k and v (:func:`qkv_rows`), and its qkv
  bias the same rows. proj and fc2 keep their rows and take the columns of
  the rank's heads / MLP share; their biases, the LayerNorms, the patch
  embedding, cls / pos and the head stay whole on every rank. ``model >
  num_heads`` raises (a rank with no head: ROADMAP.md Queue 3 item 7).
- **The collectives** (Megatron's ``f`` and ``g``): qkv and fc1 are
  column-parallel, their input passes :func:`copy_to_model` (identity
  forward, the all-reduce of ``dx`` over the model group backward); proj and
  fc2 are row-parallel, their partial product passes
  :func:`reduce_from_model` (the all-reduce SUM forward, identity backward)
  before the bias add and the output fake-quant. Both sum in f32.
- **The state.** :func:`split_params` takes a rank's shard of a whole
  state dict (parameters, AdamW moments), :func:`gather_params` the whole
  back from every model rank's shard (:func:`join_params` in one process);
  ``gather_params(split_params(p)) == p`` exactly. :func:`shard_module`
  splits a built model in place for this rank.

Observers see the whole tensor: under a model axis every observer, weight
and activation, reduces its min / max over the whole world (the trainer
sets ``FakeQuantConfig.axis_name``), which is exact and a no-op for a
replicated tensor; a weight shard is so fake-quantized with the whole
weight's qparams and equals that slice of the fake-quantized whole.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

# the residue a mesh with more model ranks than heads names (a rank with no head)
HEADS_RESIDUE = "ROADMAP.md Queue 3 item 7: model > num_heads"

COLUMN, ROW = "column", "row"
# the split layers: (module path in a block, parallel kind)
SPLIT_LAYERS = (("attn.qkv", COLUMN), ("attn.proj", ROW), ("mlp.fc1", COLUMN),
                ("mlp.fc2", ROW))


def share(n: int, k: int, m: int) -> Tuple[int, int]:
    """Rank ``m``'s contiguous share ``[lo, hi)`` of ``n`` things over ``k``
    ranks, the first ``n % k`` ranks one more (``np.array_split``)."""
    base, extra = divmod(n, k)
    lo = m * base + min(m, extra)
    return lo, lo + base + (1 if m < extra else 0)


def check_heads(num_heads: int, k: int) -> None:
    if k > num_heads:
        raise ValueError(f"model={k} > num_heads={num_heads}: a model rank would hold no "
                         f"head ({HEADS_RESIDUE})")


def head_bounds(cfg, k: int, m: int) -> Tuple[int, int]:
    """Rank ``m``'s heads ``[lo, hi)`` of ``cfg.num_heads`` over ``k`` ranks."""
    check_heads(cfg.num_heads, k)
    return share(cfg.num_heads, k, m)


def qkv_rows(cfg, k: int, m: int) -> torch.Tensor:
    """Rank ``m``'s rows of the qkv weight (and bias): its heads' rows in
    each of q, k and v, in that order (never a contiguous third)."""
    lo, hi = head_bounds(cfg, k, m)
    d, hd = cfg.embed_dim, cfg.head_dim
    return torch.cat([torch.arange(s * d + lo * hd, s * d + hi * hd) for s in range(3)])


def _index(name: str, cfg, k: int, m: int) -> Optional[Tuple[int, torch.Tensor]]:
    """``(dim, indices)`` of rank ``m``'s shard of the state entry ``name``,
    None for a replicated entry."""
    if not name.startswith("blocks."):
        return None
    layer, _, leaf = name.split(".", 2)[2].rpartition(".")
    if layer == "attn.qkv" and leaf in ("weight", "bias"):
        return 0, qkv_rows(cfg, k, m)
    lo, hi = head_bounds(cfg, k, m)
    if layer == "attn.proj" and leaf == "weight":
        return 1, torch.arange(lo * cfg.head_dim, hi * cfg.head_dim)
    lo, hi = share(cfg.mlp_dim, k, m)
    if layer == "mlp.fc1" and leaf in ("weight", "bias"):
        return 0, torch.arange(lo, hi)
    if layer == "mlp.fc2" and leaf == "weight":
        return 1, torch.arange(lo, hi)
    return None


def is_split(name: str, cfg) -> bool:
    """Whether the state entry ``name`` is split over the model axis."""
    return _index(name, cfg, 1, 0) is not None


def split_state(full: Dict[str, torch.Tensor], cfg, k: int, m: int) -> Dict[str, torch.Tensor]:
    """Rank ``m`` of ``k``'s shard of a whole state dict (a new dict; split
    entries are new tensors, replicated ones the same)."""
    out = {}
    for name, t in full.items():
        where = _index(name, cfg, k, m)
        out[name] = t if where is None else t.index_select(where[0], where[1].to(t.device))
    return out


def split_params(full_state: Dict[str, torch.Tensor], cfg, mesh) -> Dict[str, torch.Tensor]:
    """This rank's shard of a whole state dict (``mesh.model_index`` of
    ``mesh.model``)."""
    if mesh.model == 1:
        return dict(full_state)
    return split_state(full_state, cfg, mesh.model, mesh.model_index)


def join_params(shards: Sequence[Dict[str, torch.Tensor]], cfg) -> Dict[str, torch.Tensor]:
    """The whole state dict from every model rank's shard, in rank order
    (replicated entries from rank 0's)."""
    k = len(shards)
    out = {}
    for name, t in shards[0].items():
        where = _index(name, cfg, k, 0)
        if where is None:
            out[name] = t
            continue
        dim = where[0]
        shape = list(t.shape)
        shape[dim] = sum(s[name].shape[dim] for s in shards)
        whole = t.new_empty(shape)
        for m, s in enumerate(shards):
            whole.index_copy_(dim, _index(name, cfg, k, m)[1].to(t.device), s[name])
        out[name] = whole
    return out


def gather_params(shard_state: Dict[str, torch.Tensor], cfg, mesh) -> Dict[str, torch.Tensor]:
    """The whole state dict on every rank of this rank's model group, from
    each one's shard (one all-gather per split entry, padded to the largest
    share); every rank of the group must call it with the same keys."""
    if mesh.model == 1:
        return dict(shard_state)
    k = mesh.model
    shards: List[Dict[str, torch.Tensor]] = [dict() for _ in range(k)]
    for name, t in shard_state.items():
        where = _index(name, cfg, k, mesh.model_index)
        if where is None:
            for s in shards:
                s[name] = t
            continue
        dim = where[0]
        sizes = [len(_index(name, cfg, k, m)[1]) for m in range(k)]
        pad = list(t.shape)
        pad[dim] = max(sizes) - t.shape[dim]
        mine = torch.cat([t, t.new_zeros(pad)], dim).contiguous()
        got = [torch.empty_like(mine) for _ in range(k)]
        dist.all_gather(got, mine, group=mesh.model_group)
        for m in range(k):
            shards[m][name] = got[m].narrow(dim, 0, sizes[m])
    return join_params(shards, cfg)


# ---------------------------------------------------------------------------
# the collectives of the split layers
# ---------------------------------------------------------------------------

def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, in f32, back in ``t``'s dtype."""
    out = t.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """A column-parallel layer's input: identity forward, the gradient
    all-reduced over ``group`` backward (each rank's ``dx`` is its heads'
    share)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel layer's partial product summed over ``group``
    (forward), the gradient passed through (backward)."""
    return _ReduceFromModel.apply(x, group)


# ---------------------------------------------------------------------------
# a built model, split in place
# ---------------------------------------------------------------------------

def shard_module(module: nn.Module, mesh) -> nn.Module:
    """Split a whole ``VisionTransformer`` in place for this rank of
    ``mesh`` (a no-op with ``model`` 1): its qkv / proj / fc1 / fc2 weights
    (and the qkv / fc1 biases) become this rank's shards, marked
    ``tp_group`` (the clip sums their norms over the group), the split
    layers run the collectives, each attention runs its own heads, and
    ``module.mesh`` is the mesh. Build the optimizer after it. The
    attention kernels stay off, as under JAX's model axis: a config with
    ``fast_math`` and ``attn_kernel`` raises."""
    cfg = module.cfg
    if mesh.model == 1:
        return module
    check_heads(cfg.num_heads, mesh.model)
    if cfg.fast_math and cfg.attn_kernel:
        raise ValueError("the attention kernels do not run under a model axis (JAX's gate, "
                         "train/trainer.py): build the model with attn_kernel=False")
    shards = split_params(module.state_dict(), cfg, mesh)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if is_split(name, cfg):
                p.data = shards[name].clone()
                p.tp_group = mesh.model_group
    lo, hi = head_bounds(cfg, mesh.model, mesh.model_index)
    for blk in module.blocks:
        blk.attn.heads = hi - lo
        for path, kind in SPLIT_LAYERS:
            layer = blk.get_submodule(path)
            layer.tp, layer.tp_group = kind, mesh.model_group
    module.mesh = mesh
    return module
