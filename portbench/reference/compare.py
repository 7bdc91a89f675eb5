"""The comparisons that decide ``correct``: each returns the numbers
compared, each beside its limit (from the cell's limits file)."""

from __future__ import annotations

import statistics
from typing import Dict

import torch

# an element whose reference gradient is under this share of the median
# leaf's root-mean-square gradient is nought to rounding (a key's bias under
# softmax): AdamW moves it by round-off alone, so its change is not compared
TINY_GRAD_SHARE = 1e-3


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in rn}


def leaf_diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm of the difference between the program's and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's: unlike a gap of norms, it sees a gradient that points
    elsewhere with the same length (a mean over other rows)."""
    rn = _norms(ref)
    med = statistics.median(rn.values())
    return {k: float(torch.linalg.vector_norm((prog[k].to(v.device) - v).double()))
            / max(rn[k], med, 1e-30) for k, v in ref.items()}


def moving_masks(ref_g1: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per leaf, the elements whose reference gradient is not nought to
    rounding (:data:`TINY_GRAD_SHARE` of the median leaf's RMS gradient)."""
    rms = [float(torch.linalg.vector_norm(g.double())) / max(1, g.numel()) ** 0.5
           for g in ref_g1.values()]
    floor = TINY_GRAD_SHARE * statistics.median(rms)
    return {k: g.abs() >= floor for k, g in ref_g1.items()}


def train_diagnostics(ref_losses, ref_g1, ref_delta, losses, g1, delta) -> Dict[str, float]:
    """Every candidate reading of a training comparison: each step's loss
    gap, and the worst, the 90th-percentile and the median leaf of the
    gradient and the change, by the gap of norms and by the norm of the
    difference."""
    out = {f"loss_rel_step{i + 1}": abs(a - b) / abs(b)
           for i, (a, b) in enumerate(zip(losses, ref_losses))}
    masks = moving_masks(ref_g1)
    kept = {k: m.to(delta[k].device) for k, m in masks.items()}
    moved = {k: delta[k] * kept[k] for k in kept}
    ref_moved = {k: ref_delta[k] * masks[k] for k in masks}
    for name, gaps in (("grad", leaf_gaps(g1, ref_g1)), ("update", leaf_gaps(moved, ref_moved)),
                       ("grad_diff", leaf_diffs(g1, ref_g1)),
                       ("update_diff", leaf_diffs(moved, ref_moved))):
        out[f"{name}_worst"] = max(gaps.values())
        out[f"{name}_median"] = statistics.median(gaps.values())
        out[f"{name}_p90"] = p90(gaps.values())
    return out


def p90(values) -> float:
    """The 90th-percentile value (the leaf a tenth of the leaves lie above)."""
    xs = sorted(values)
    return xs[int(0.9 * (len(xs) - 1))]


def train_readings(ref_g1, ref_delta, g1, delta, limits) -> Dict[str, Dict[str, float]]:
    """The numbers a training cell compares: at the 90th-percentile leaf
    the first gradient's norm gap (the worst leaf is the cls token's, whose
    one path swings with bf16 noise from seed to seed) and its norm of the
    difference (a step on part of the batch: the clip leaves its norms
    alike), and the worst leaf's change over the checked steps (elements
    whose reference gradient is nought to rounding left out). Each step's
    loss is printed only (:func:`train_diagnostics`)."""
    masks = moving_masks(ref_g1)
    kept = {k: m.to(delta[k].device) for k, m in masks.items()}
    change = leaf_gaps({k: delta[k] * kept[k] for k in kept},
                       {k: ref_delta[k] * masks[k] for k in masks})
    return {
        "grad_norm_gap_p90_leaf": {"value": p90(leaf_gaps(g1, ref_g1).values()),
                                   "limit": limits["grad_norm_gap_p90_leaf"]},
        "grad_diff_p90_leaf": {"value": p90(leaf_diffs(g1, ref_g1).values()),
                               "limit": limits["grad_diff_p90_leaf"]},
        "update_norm_gap_worst_leaf": {"value": max(change.values()),
                                       "limit": limits["update_norm_gap_worst_leaf"]},
    }


def rows_rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's (image's) relative L2 distance."""
    g = got.double().reshape(got.shape[0], -1)
    w = want.double().reshape(want.shape[0], -1)
    num = torch.linalg.vector_norm(g - w, dim=1)
    den = torch.linalg.vector_norm(w, dim=1).clamp(min=1e-30)
    return float((num / den).max())


def outputs_readings(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                     limits) -> Dict[str, Dict[str, float]]:
    """Per output, the worst image's relative L2 distance from the
    reference (NaN or inf anywhere reads inf)."""
    out = {}
    for k in want:
        g = got[k].to(want[k].device)
        v = rows_rel_l2(g, want[k]) if bool(torch.isfinite(g).all()) else float("inf")
        out[f"{k}_rel_l2"] = {"value": v, "limit": limits[f"{k}_rel_l2"]}
    return out

