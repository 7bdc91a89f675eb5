"""Readings behind the limits of chip_smoke.py's data-parallel steps (phase
11, ``DP_LIMITS`` / ``DP_DET_LIMITS``): two ranks sharing the card (gloo),
each DP step held against one process's step on the global batch from the
same state (``parallel.dryrun.step_against_one_process``), at several seeds,
for the sound run and three planted faults:

- ``no_allreduce``: no DDP replica, each rank steps on its own shard's
  gradients;
- ``sum``: DDP's all-reduce without the division by the world size
  (gradients summed, not averaged);
- ``no_obs_reduce``: the activation observers without the MIN / MAX
  reduction over the ranks (each rank's own statistics).

The steps are phase 11's: ViT-S/16 from a bf16 ViT-B/16 at 128 images per
rank (3 float, 3 observing QAT, 1 frozen QAT step) and OWLv2-pruned at
depth 2, 8 images per rank (1 float, 1 QAT step). Metrics: the loss
averaged over the ranks (``loss_rel``), the global gradient norm before the
clip (``grad_norm_rel``), the parameters after the step (``params_rel_l2``),
the activation observers after an observing step (``obs_rel``), and
whether the ranks hold the same parameters and observers.

Prints every reading, then per part and metric the largest sound reading
and, for each fault, the least over the seeds of its largest reading in a
run (a limit between them catches the fault at every seed and passes every
sound step), and last those as one JSON line.

    python3 port_scripts/dp_bounds.py [SEED ...]     (default 0 to 7)
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

VARIANTS = (None, "no_allreduce", "sum", "no_obs_reduce")
METRICS = ("loss_rel", "grad_norm_rel", "params_rel_l2", "obs_rel")


def held(metric, step):
    """Whether phase 11 holds ``metric`` at a step of kind ``step``."""
    return not (metric == "loss_rel" and step != "float") and not (
        metric == "obs_rel" and step != "qat")


def main(argv):
    import torch

    seeds = [int(a) for a in argv] or list(range(8))
    if not torch.cuda.is_available():
        sys.exit("dp_bounds: needs a CUDA GPU")
    from qat_vit_tpu_torch import _build

    print(cs.card_line(), flush=True)
    print(f"kernels built in {_build.load().build_seconds:.1f} s", flush=True)
    readings = {}  # (variant, part, metric) -> [(seed, step, value)]
    apart = {}  # (variant, part) -> steps whose ranks differ
    with tempfile.TemporaryDirectory(prefix="dp_bounds_") as tmp:
        for variant in VARIANTS:
            name = variant or "sound"
            t0 = time.perf_counter()
            results, _ = cs.dp_launch({"parts": ["vit", "detect"], "seeds": seeds,
                                       "fault": variant, "full": False}, cs.DP_WORLD,
                                      os.path.join(tmp, name), timeout=3000,
                                      env={"CUDA_VISIBLE_DEVICES": "0"})
            res = results[0]
            for seed in seeds:
                for part in ("vit", "detect"):
                    for i, row in enumerate(res[str(seed)][part]["rows"]):
                        print(f"{name} seed {seed} {part} step {i + 1} ({row['step']}): "
                              + ", ".join(f"{m} {row[m]:.3e}" for m in METRICS)
                              + f", ranks identical {row['ranks_identical']}", flush=True)
                        for m in METRICS:
                            if held(m, row["step"]):
                                readings.setdefault((name, part, m), []).append(
                                    (seed, row["step"], row[m]))
                        if not row["ranks_identical"]:
                            apart.setdefault((name, part), []).append((seed, i + 1))
            print(f"{name}: {len(seeds)} seeds in {time.perf_counter() - t0:.1f} s "
                  f"({res['backend']}, {res['world']} ranks)", flush=True)
    summary = {}
    for part in ("vit", "detect"):
        for m in METRICS:
            sound = readings.get(("sound", part, m), [])
            line = {"sound_max": max((v for _, _, v in sound), default=None)}
            for variant in VARIANTS[1:]:
                # a fault is caught in a run when one of its steps reads past
                # the limit: per seed its largest reading, then the least of those
                per_seed = {}
                for seed, _, v in readings.get((variant, part, m), []):
                    per_seed[seed] = max(per_seed.get(seed, v), v)
                line[f"{variant}_min"] = min(per_seed.values(), default=None)
            summary[f"{part} {m}"] = line
            print(f"{part} {m}: " + ", ".join(f"{k} {v:.3e}" if v is not None else f"{k} -"
                                              for k, v in line.items()), flush=True)
    for variant in ("sound",) + VARIANTS[1:]:
        for part in ("vit", "detect"):
            steps = apart.get((variant, part), [])
            summary[f"{part} ranks apart ({variant})"] = len(steps)
            print(f"{part} {variant}: ranks apart after {len(steps)} steps", flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
