"""Readings behind the limits of chip_smoke.py's tensor-parallel steps (phase
13, ``TP_LIMITS``): two ranks sharing the card (gloo) as a (data 1, model 2)
rank grid, ``KDQATTrainer`` with ``model_parallel`` 2 on ViT-S/16 at full
width, depth 12, 224 px, from a bf16 ViT-B/16: one float and one observing
QAT step on a global batch of 32, each split over the ranks and held against
one process's step from the same whole state
(``parallel.dryrun.tp_step_against_one_process``), at several seeds, for the
sound run and three planted faults (``chip_smoke.tp_plant``):

- ``qkv_contiguous``: each rank takes a contiguous 1/k of qkv's rows (not
  its heads' rows in each of q, k and v);
- ``proj_unreduced``: proj's partial product is not summed over the model
  ranks;
- ``clip_twice``: the clip's squared norm, replicated gradients included,
  is summed over the model ranks (the replicated ones counted twice).

Metrics: the loss averaged over the ranks (``loss_rel``), the global
gradient norm before the clip (``grad_norm_rel``), every parameter after
the step, gathered (``params_rel_l2``), every observer after the QAT step
(``obs_rel``), the first block's qkv weight gradient after the clip,
gathered (``qkv_grad_rel``); and whether the weight observers and the ranks
are identical.

Prints every reading, then per metric the largest sound reading and, for
each fault, the least over the seeds of its largest reading in a run (a
limit between them catches the fault at every seed and passes every sound
step), and last those as one JSON line.

    python3 port_scripts/tp_bounds.py [SEED ...]     (default 0 to 3)
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

VARIANTS = (None, "qkv_contiguous", "proj_unreduced", "clip_twice")


def held(metric, step):
    """Whether phase 13 holds ``metric`` at a step of kind ``step``."""
    return not (metric == "obs_rel" and step != "qat")


def main(argv):
    import torch

    seeds = [int(a) for a in argv] or list(range(4))
    if not torch.cuda.is_available():
        sys.exit("tp_bounds: needs a CUDA GPU")
    from qat_vit_tpu_torch import _build

    print(cs.card_line(), flush=True)
    print(f"kernels built in {_build.load().build_seconds:.1f} s", flush=True)
    readings = {}  # (variant, metric) -> [(seed, step, value)]
    flags = {}  # (variant, flag) -> steps where it was False
    with tempfile.TemporaryDirectory(prefix="tp_bounds_") as tmp:
        for variant in VARIANTS:
            name = variant or "sound"
            t0 = time.perf_counter()
            results, _ = cs.tp_launch({"model": 2, "seeds": seeds, "fault": variant,
                                       "timed": False}, 2, os.path.join(tmp, name),
                                      timeout=3000, env={"CUDA_VISIBLE_DEVICES": "0"})
            res = results[0]
            for seed in seeds:
                for row in res[str(seed)]["rows"]:
                    print(f"{name} seed {seed} {row['step']}: "
                          + ", ".join(f"{m} {row[m]:.3e}" for m in cs.TP_METRICS)
                          + f", weight observers identical {row['weight_obs_equal']}, ranks "
                          f"identical {row['ranks_identical']}", flush=True)
                    for m in cs.TP_METRICS:
                        if held(m, row["step"]):
                            readings.setdefault((name, m), []).append(
                                (seed, row["step"], row[m]))
                    for flag in ("weight_obs_equal", "ranks_identical"):
                        if not row[flag]:
                            flags.setdefault((name, flag), []).append((seed, row["step"]))
            print(f"{name}: {len(seeds)} seeds in {time.perf_counter() - t0:.1f} s "
                  f"({res['backend']}, {res['world']} ranks)", flush=True)
    summary = {}
    for m in cs.TP_METRICS:
        sound = readings.get(("sound", m), [])
        line = {"sound_max": max((v for _, _, v in sound), default=None)}
        for variant in VARIANTS[1:]:
            # a fault is caught in a run when one of its steps reads past the
            # limit: per seed its largest reading, then the least of those
            per_seed = {}
            for seed, _, v in readings.get((variant, m), []):
                per_seed[seed] = max(per_seed.get(seed, v), v)
            line[f"{variant}_min"] = min(per_seed.values(), default=None)
        summary[m] = line
        print(f"{m}: " + ", ".join(f"{k} {v:.3e}" if v is not None else f"{k} -"
                                   for k, v in line.items()), flush=True)
    for variant in ("sound",) + VARIANTS[1:]:
        for flag in ("weight_obs_equal", "ranks_identical"):
            steps = flags.get((variant, flag), [])
            summary[f"{flag} false ({variant})"] = len(steps)
            print(f"{variant}: {flag} false after {len(steps)} steps", flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
