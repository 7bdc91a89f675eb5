"""Variants of K9a / K9b (csrc/megablock.cu), each in a build of its own and
never in the shipped kernel, timed in turns on one card.

Each variant is megablock.cu compiled with other macros and linked with the
other sources' objects (built once) into a library of its own; the wrappers
(ops.block_kernel) run on it in place of the shipped build:

- "shipped": the macros' defaults (256 threads, thread 0 fills the ring,
  one block per SM, a 4-stage ring, K2c's tiles up to 64 rows);
- "32-row K2c tiles": QVT_K9_RL_ROWS_MAX=32;
- "2 blocks/SM, 2 stages": QVT_K9_MINB=2 (two blocks' register cap, 128)
  with a 2-stage ring (two blocks' shared memory; K2c's tiles and K3's
  form fit the smaller GEMM region);
- "stamps": QVT_K9_STAMPS, %globaltimer after each grid barrier (block 0)
  and at each block's arrival there: per stage, the mean ms over the 12
  blocks of K9b and the mean ms a block waits at the stage's barrier (its
  share of the stage is SM time idle in the last wave and the barrier,
  the most that per-image readiness counters in place of the barriers
  could win back);

On a ViT-S/16 export (random init, as port_scripts/k9_check.py makes it):
each variant's K9a (block 0) and K9b (12 blocks) x and zq are compared
with the megamodel kernel chain once (identical), then each is timed in
turns (the list, then the list reversed): device ms under torch.profiler
(20 calls) per K9a block and per K9b forward at batch 32 and 256. Prints
the card's name and power limit, each variant's residency (blocks per SM x
SMs, threads, shared memory) and a JSON line of all readings.

    python3 port_scripts/k9_variants.py [--only NAME ...]
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402
import k9_check  # noqa: E402
from qat_vit_tpu_torch import _build  # noqa: E402
from qat_vit_tpu_torch.ops import block_kernel as bk  # noqa: E402

BUILDS = {
    "shipped": [],
    "32-row K2c tiles": ["-DQVT_K9_RL_ROWS_MAX=32"],
    "2 blocks/SM, 2 stages": ["-DQVT_K9_MINB=2", "-DQVT_K9_STAGES=2"],
    "stamps": ["-DQVT_K9_STAMPS"],
}
STAGE_NAMES = ("qkv", "attention", "proj", "fc1", "fc2")


def build(names):
    """{name: KernelLibrary}: megablock.cu per variant, the rest once."""
    nvcc = _build._nvcc()
    tmp = tempfile.mkdtemp()
    others = [p for p in sorted(_build.CSRC.glob("*.cu")) if p.name != "megablock.cu"]
    objs = [os.path.join(tmp, p.stem + ".o") for p in others]
    cmds = [[nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c", str(p), "-o", o]
            for p, o in zip(others, objs)]
    for i, name in enumerate(names):
        cmds.append([nvcc, *_build.NVCC_FLAGS, *BUILDS[name], "-Xptxas", "-v", "-I",
                     str(_build.CSRC), "-c", str(_build.CSRC / "megablock.cu"), "-o",
                     os.path.join(tmp, f"megablock_{i}.o")])
    t0 = time.perf_counter()
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for c in cmds]
    failed = set()
    for c, p in procs:
        out, err = p.communicate()
        if c[-1].startswith(os.path.join(tmp, "megablock_")):
            i = int(c[-1].rsplit("_", 1)[1].split(".")[0])
            regs = [ln.strip() for ln in (out + err).splitlines()
                    if "registers" in ln or "spill" in ln or "error" in ln]
            print(f"{names[i]}: nvcc rc {p.returncode}; " + " | ".join(regs), flush=True)
            if p.returncode:
                failed.add(names[i])
        elif p.returncode:
            sys.exit(f"build failed: {' '.join(c)}\n{err}")
    print(f"built in {time.perf_counter() - t0:.0f} s", flush=True)
    libs = {}
    for i, name in enumerate(names):
        if name in failed:
            continue
        lib = os.path.join(tmp, f"lib_{i}.so")
        _build._run([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib, *objs,
                      os.path.join(tmp, f"megablock_{i}.o")]])
        libs[name] = _build.KernelLibrary(lib, 0.0)
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", help="variants to build (default: all)")
    args = ap.parse_args()
    names = args.only or list(BUILDS)
    card = cs.card_line()
    print(card, flush=True)
    libs = build(names)
    dev = torch.device("cuda")
    cfg, qp, images = k9_check.vit_s_export(dev)
    kw = dict(num_heads=cfg.num_heads, head_dim=cfg.head_dim, eps=cfg.layer_norm_eps)
    blk0, nxt = qp["blocks"]["0"], qp["blocks"]["1"]["norm1"]
    inputs = {b: k9_check.stream_in(qp, cfg, images[:b], torch.bfloat16) for b in (32, 256)}
    pairs = [(qp["blocks"][str(i)], qp["blocks"][str(i + 1)]["norm1"] if i + 1 < cfg.depth
              else qp["norm"]) for i in range(cfg.depth)]
    load = _build.load

    def forms(b):
        zq, x = inputs[b]
        n = zq.shape[1]
        return {"K9a": lambda: bk.megablock_forward(zq, x, blk0, nxt, n_valid=n, **kw),
                "K9b": lambda: bk._launch_megablock(zq, x, pairs, n_valid=n, quant_max=255.0,
                                                    name="megamodel_res", **kw)}

    rows = [(name, name) for name in libs if not name.startswith("stamps")]
    res = (ctypes.c_int * 6)()
    readings = {}
    try:
        for label, name in rows:  # bits and residency
            _build.load = lambda lib=libs[name]: lib
            libs[name].call("qvt_megablock_residency", 197, cfg.num_heads, cfg.head_dim, 1,
                            ctypes.addressof(res))
            for b in (32, 256):
                zq, x = inputs[b]
                chain = {"K9a": bk.block_forward(zq, x, blk0, nxt, n_valid=zq.shape[1], **kw),
                         "K9b": bk.model_forward(zq, x, qp["blocks"], qp["norm"],
                                                 depth=cfg.depth, n_valid=zq.shape[1], **kw)}
                for form, fn in forms(b).items():
                    same = all(torch.equal(a, w) for a, w in zip(fn(), chain[form]))
                    if not same:
                        sys.exit(f"{label} {form} batch {b}: differs from the chain")
            print(f"{label}: identical to the chain at batch 32 and 256; {res[0]} blocks of "
                  f"{res[2]} threads per SM x {res[1]} SMs, {res[3]} bytes of shared memory",
                  flush=True)
        for label, name in rows + rows[::-1]:  # in turns
            _build.load = lambda lib=libs[name]: lib
            for b in (32, 256):
                for form, fn in forms(b).items():
                    readings.setdefault(f"{label} {form} batch {b}", []).append(
                        cs.device_ms(torch, fn))
        for key, v in readings.items():
            print(f"{key}: device ms {' / '.join(f'{t:.4f}' for t in v)}", flush=True)
        for stamped in [name for name in libs if name.startswith("stamps")]:
            lib = libs[stamped]
            _build.load = lambda lib=lib: lib
            lib.call("qvt_megablock_residency", 197, cfg.num_heads, cfg.head_dim, 1,
                     ctypes.addressof(res))
            grid, bars = res[0] * res[1], 5 * cfg.depth
            releases = torch.zeros(bars + 1, dtype=torch.int64, device=dev)
            arrivals = torch.zeros(bars, grid, dtype=torch.int64, device=dev)
            err = lib._lib.qvt_megablock_stamps(ctypes.c_void_p(releases.data_ptr()),
                                                ctypes.c_void_p(arrivals.data_ptr()))
            if err:
                sys.exit(f"qvt_megablock_stamps: cudaError {err}")
            for b in (32, 256):
                fn = forms(b)["K9b"]
                per, wait, least = np.zeros(5), np.zeros(5), np.zeros(5)
                for _ in range(10):
                    fn()
                    torch.cuda.synchronize()
                    rel = releases.cpu().numpy().astype(np.float64)
                    waits = (rel[1:, None] - arrivals.cpu().numpy()) / 1e6  # [bars, grid]
                    for acc, v in ((per, np.diff(rel) / 1e6), (wait, waits.mean(1)),
                                   (least, waits.min(1))):
                        acc += v.reshape(cfg.depth, 5).sum(0) / cfg.depth / 10
                readings[f"{stamped} K9b batch {b}"] = {
                    s: {"ms": t, "wait_ms": w, "last_wait_ms": lw}
                    for s, t, w, lw in zip(STAGE_NAMES, per.tolist(), wait.tolist(),
                                           least.tolist())}
                print(f"{stamped} K9b batch {b}: mean ms per block by stage (a block's mean "
                      "wait at its barrier, the last arriver's) "
                      + ", ".join(f"{s} {t:.4f} ({w:.4f}, {lw:.4f})"
                                  for s, t, w, lw in zip(STAGE_NAMES, per, wait, least))
                      + f"; sum {per.sum():.4f} per block, {per.sum() * cfg.depth:.3f} per "
                      f"forward; waiting {wait.sum() / per.sum():.1%} of the SMs' time "
                      f"({grid} blocks)", flush=True)
    finally:
        _build.load = load
    print(json.dumps({"card": card, "readings": readings}), flush=True)
    print(f"done on {card}", flush=True)


if __name__ == "__main__":
    main()
