"""Readings behind the limits of chip_smoke.py's detection replay (phase 6,
``DT_REPLAY_*``): the replay's trainer (OWLv2-pruned student at full width,
depth 2, batch 2) at several seeds, each step run from the same state
through the plain versions, through K5a with K5b's plain version (the
hybrid) and through the attentions below, each compared by the replay's
metrics: the loss and the parameters after the step against the plain
step; the gradient, its part on the qkv weights and the update against
the hybrid step.

- sound: the kernels (K5a / K5b on the tensor cores), exact attention
  (``long_attention_f64`` rounded to bf16, forward and backward) and K5a
  with the exact backward;
- faulty: K5b with dk, or dv, zeroed on one key tile; K5a with the exact
  backward of qkv rounded to float8 e4m3; K5a with one head's output zeroed;
  float8 attention (forward and backward).

Prints every reading, then per phase and metric the largest sound reading
and the smallest faulty one (a limit must lie between them), and last
those as one JSON line.

    python3 port_scripts/replay_bounds.py [SEED ...]     (default 0 to 7)
"""
import contextlib
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10  # noqa: E402
from qat_vit_tpu_torch.ops import long_attention as la  # noqa: E402
from qat_vit_tpu_torch.ops._cuda import reference_impl  # noqa: E402

METRICS = ("loss", "params", "grad", "qkv_grad", "update")
# per metric: the variants that must pass it and those it should catch (the
# backward's metrics compare variants that share K5a's forward)
FWD_SOUND, FWD_FAULTY = ("kernels", "exact"), ("head_zeroed", "float8")
BWD_SOUND, BWD_FAULTY = ("kernels", "exact_bwd"), ("dk_tile_zeroed", "dv_tile_zeroed", "float8_bwd")
SOUND = {"loss": FWD_SOUND, "params": FWD_SOUND, "grad": BWD_SOUND, "qkv_grad": BWD_SOUND,
         "update": BWD_SOUND}
FAULTY = {"loss": FWD_FAULTY, "params": FWD_FAULTY, "grad": BWD_FAULTY,
          "qkv_grad": BWD_FAULTY, "update": BWD_FAULTY}
KEY_TILE = slice(1024, 1088)  # 64 keys of the 2,305


def float8(qkv):
    return qkv.float().clamp(-448, 448).to(torch.float8_e4m3fn).to(qkv.dtype)


def f64_fwd(round_in):
    def fwd(qkv, heads, hd, *, n_valid=None):
        return la.long_attention_f64(round_in(qkv), heads, hd, n_valid=n_valid)[0].to(qkv.dtype)
    return fwd


def f64_bwd(round_in):
    def bwd(qkv, do, heads, hd, *, n_valid=None, out=None, lse=None):
        return la.long_attention_f64(round_in(qkv), heads, hd, do,
                                     n_valid=n_valid)[1].to(qkv.dtype)
    return bwd


def zeroed_bwd(section):
    """K5b with its ``section`` (1: dk, 2: dv) zeroed on ``KEY_TILE``."""
    kernel = la.long_attention_bwd

    def bwd(qkv, do, heads, hd, *, n_valid=None, out=None, lse=None):
        dqkv = kernel(qkv, do, heads, hd, n_valid=n_valid, out=out, lse=lse)
        d = heads * hd
        dqkv[:, KEY_TILE, section * d:(section + 1) * d] = 0
        return dqkv
    bwd.launches = 0  # the kernel counts its launches under its module name
    return bwd


def head_zeroed():
    """K5a's training launch with head 0's output zeroed."""
    launch = la._attention_launch

    def fwd(qkv, heads, hd, n_valid, want_lse=False):
        out, lse = launch(qkv, heads, hd, n_valid, want_lse=want_lse)
        out[..., :hd] = 0
        return out, lse
    return fwd


def variants():
    """(name, context manager factory) for :func:`chip_smoke.replay_detect`."""
    def plain_swap(round_in):
        @contextlib.contextmanager
        def ctx():
            with reference_impl(), cs.swapped(la, long_attention_qkv_plain=f64_fwd(round_in),
                                              long_attention_bwd_plain=f64_bwd(round_in)):
                yield
        return ctx

    def exact(t):
        return t

    return [("kernels", contextlib.nullcontext),
            ("exact", plain_swap(exact)),
            ("exact_bwd", lambda: cs.swapped(la, long_attention_bwd=f64_bwd(exact))),
            ("dk_tile_zeroed", lambda: cs.swapped(la, long_attention_bwd=zeroed_bwd(1))),
            ("dv_tile_zeroed", lambda: cs.swapped(la, long_attention_bwd=zeroed_bwd(2))),
            ("float8_bwd", lambda: cs.swapped(la, long_attention_bwd=f64_bwd(float8))),
            ("head_zeroed", lambda: cs.swapped(la, _attention_launch=head_zeroed())),
            ("float8", plain_swap(float8))]


def main():
    seeds = [int(a) for a in sys.argv[1:]] or list(range(8))
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = []
    for seed in seeds:
        t0 = time.perf_counter()
        torch.manual_seed(seed)
        data = synthetic_cifar10(n_train=cs.DT_N_TRAIN, n_test=cs.DT_EVAL_B, seed=seed)
        t = cs.detect_trainer(torch, data, cs.DT_REPLAY_B, cs.DT_REPLAY_DEPTH, seed=seed)
        records = cs.replay_detect(torch, la, t, cs.DT_REPLAY_STEPS, variants(),
                                   reference_impl)
        del t
        for phase, rec in enumerate(records):
            for i, r in enumerate(rec):
                for name, m in r.items():
                    readings.append({"seed": seed, "phase": ("float", "QAT")[phase],
                                     "step": i + 1, "variant": name, **m})
                    print(f"seed {seed} {readings[-1]['phase']} step {i + 1} {name}: " + ", ".join(
                        f"{k} {m[k]:.3e}" for k in METRICS),
                        flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    summary = {}
    for phase in ("float", "QAT"):
        rows = [r for r in readings if r["phase"] == phase]
        for k in METRICS:
            sound = max(r[k] for r in rows if r["variant"] in SOUND[k])
            faulty = {v: min(r[k] for r in rows if r["variant"] == v) for v in FAULTY[k]}
            summary[f"{phase} {k}"] = {"sound_max": sound, "faulty_min": faulty}
            print(f"{phase} {k}: sound max {sound:.3e}; faulty min " + ", ".join(
                f"{v} {x:.3e}" for v, x in faulty.items()), flush=True)
    print(json.dumps({"card": cs.card_line(), "seeds": seeds, "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
