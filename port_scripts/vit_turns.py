"""ViT-S/16 and OWLv2-pruned end to end through two checkouts of the port, in turns on
one card: for each checkout in the order parent, change, change, parent, a fresh
process that imports the package from that checkout, builds its kernels and measures

- int8 serving: phase 3's export of chip_smoke.py (random init from seed 0, PTQ over
  4 x 32 images) through the megamodel chain at batch 256, ms per forward (CUDA
  events, median of 10 after 3 warm-up calls), and the device time of one forward by
  kernel group under torch.profiler;
- int8 detection: phase 5's OWLv2-pruned export (random init from seed 0, calibrated on
  2 seeded images) through the serving preset (megamodel_long) at batch 8 with 4
  queries, ms per forward as above, and its device time by kernel group;
- training (not with --serve-only): KDQATTrainer at batch 256 under the trainer's
  defaults (bf16, fast_math, fq_in_kernel) with a random-init ViT-B/16 teacher, teacher
  logits cached, 4 float steps, the QAT switch, 4 QAT steps: host ms per step ending in
  a synchronize, the median of the steps after the first.

With --f32, instead of all three: an f32 fast_math ViT-S/16 student (fq_in_kernel, full
depth, random init from seed 0; the trainer builds fast_math models in bf16 only, so the
train steps are called directly, as chip_smoke.py's f32 replay does) at batch 256 with
seeded teacher logits, 4 float steps and 4 QAT steps from one state: host ms per step as
above, and the device time of one more step of each by kernel.

    python3 port_scripts/vit_turns.py PARENT_DIR CHANGE_DIR [--serve-only | --f32]
"""
import json
import os
import subprocess
import sys

CHILD = r'''
import collections, json, re, statistics, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
mode = sys.argv[2]
from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
from qat_vit_tpu_torch.data.pipeline import preprocess_fn
from qat_vit_tpu_torch.models.registry import create_student, create_teacher
from qat_vit_tpu_torch.serve.calibrate import ptq_convert
from qat_vit_tpu_torch.serve.int8_vit import export_to_device, int8_apply
from qat_vit_tpu_torch.train.config import load_hparams
from qat_vit_tpu_torch.train.trainer import KDQATTrainer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
_build.load()


def median_ms(fn, runs=10):
    for _ in range(3):
        fn()
    ts = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def by_group(fn):
    """device ms of one fn() by kernel: its name and first template argument (for
    the GEMM kernels, the epilogue)"""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    groups = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            first = re.match(r"[^<(]*<([^,>]*)", name)
            key = re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()
            groups[key + (f"<{first.group(1)}" if first else "")] += (
                e.time_range.elapsed_us() / 1e3)
    return {k: round(v, 4) for k, v in groups.most_common()}


if mode == "f32":
    from qat_vit_tpu_torch.train import steps

    s = create_student("vit", fast_math=True, fq_in_kernel=True,
                       generator=torch.Generator().manual_seed(0), device=dev).module
    r = np.random.default_rng(3)
    batch = {"image": torch.from_numpy(r.integers(0, 256, (256, 32, 32, 3), dtype=np.uint8)),
             "label": torch.from_numpy(r.integers(0, 10, 256)),
             "teacher_logits": torch.from_numpy(r.normal(0, 2, (256, 10)).astype(np.float32))}
    batch = {k: v.to(dev) for k, v in batch.items()}
    hp = steps.loss_hparams({"kd_alpha": 0.5, "kd_temperature": 4.0, "label_smoothing": 0.1}, dev)
    state = steps.TrainState(s, steps.make_optimizer(s.parameters(), 1e-3, 1e-2))
    out = {"dtype": str(next(s.parameters()).dtype)}
    for name, qat in (("float", False), ("qat", True)):
        step = steps.make_train_step(None, qat=qat, image_size=224)
        ts = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch, hp)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        out.update({f"{name}_ms": statistics.median(ts[1:]), f"{name}_steps": ts,
                    f"{name}_groups": by_group(lambda: step(state, batch, hp))})
    print(json.dumps(out), flush=True)
    sys.exit(0)

bundle = create_student("vit", generator=torch.Generator().manual_seed(0), device=dev)
cfg = bundle.cfg
rng = np.random.default_rng(1)
prep = preprocess_fn(cfg.image_size, device=dev)
calib = [prep(torch.from_numpy(rng.integers(0, 256, (32, 32, 32, 3), dtype=np.uint8)))
         for _ in range(4)]
qp = export_to_device(ptq_convert(bundle.module.state_dict(), calib, cfg, device=dev), dev)
x = prep(torch.from_numpy(np.random.default_rng(2).integers(0, 256, (256, 32, 32, 3),
                                                            dtype=np.uint8)))


def serve_fn():
    return int8_apply(qp, x, cfg, fused="megamodel", compute_dtype=torch.bfloat16)


serve = median_ms(serve_fn)
serve_groups = by_group(serve_fn)
del bundle, qp, x

from qat_vit_tpu_torch.models.registry import create_model
from qat_vit_tpu_torch.serve.calibrate import calibrate_detector
from qat_vit_tpu_torch.serve.int8_detect import convert_detector, make_int8_detect_forward

det = create_model("owlv2_pruned_detector", qat_wrapper=True,
                   generator=torch.Generator().manual_seed(0), device=dev)
dcfg = det.cfg
params = {k: v for k, v in det.module.state_dict().items()
          if not k.endswith(("min_val", "max_val"))}


def det_inputs(seed, b):
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.normal(0, 1, (b, 768, 768, 3)).astype(np.float32)).to(dev),
            torch.from_numpy(r.normal(0, 1, (b, 4, 512)).astype(np.float32)).to(dev))


stats = calibrate_detector(params, [det_inputs(10 + i, 1)[0] for i in range(2)], dcfg, device=dev)
dexp = export_to_device(convert_detector(params, stats, dcfg), dev)
fwd = make_int8_detect_forward(dcfg, dev)
dx, dq = det_inputs(20, 8)
detect = median_ms(lambda: fwd(dexp, dx, dq))
detect_groups = by_group(lambda: fwd(dexp, dx, dq))
del det, params, dexp, dx, dq
out = {"serve_ms": serve, "serve_groups": serve_groups, "detect_ms": detect,
       "detect_groups": detect_groups, "detect_preset": fwd.options.get("fused")}
if mode == "serve":
    print(json.dumps(out), flush=True)
    sys.exit(0)

data = synthetic_cifar10(n_train=1024, n_test=256, seed=0)
gen = torch.Generator().manual_seed(0)
teacher = create_teacher("vit", dtype=torch.bfloat16, generator=gen)
student = create_student("vit", generator=gen)
hp = load_hparams(None)
hp.update(batch_size=256, eval_batch_size=256, epochs=2, seed=0)
t = KDQATTrainer(hp, device=dev, data=data, student=student, teacher=teacher)
t._ensure_teacher_logits()
times = ([], [])


def timed(step, out):
    def call(state, batch, loss_hp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, batch, loss_hp)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
        return m
    return call


t.train_step_float = timed(t.train_step_float, times[0])
t.train_step_qat = timed(t.train_step_qat, times[1])
for epoch in (0, 1):
    if epoch:
        t.enable_qat()
    t.train_epoch(epoch, limit_batches=4)
out.update(float_ms=statistics.median(times[0][1:]), qat_ms=statistics.median(times[1][1:]),
           float_steps=times[0], qat_steps=times[1])
print(json.dumps(out), flush=True)
'''


def main():
    parent, change = sys.argv[1:3]
    flags = sys.argv[3:]
    mode = "f32" if "--f32" in flags else "serve" if "--serve-only" in flags else "all"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    runs = []
    for name, root in (("parent", parent), ("change", change), ("change", change),
                       ("parent", parent)):
        r = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(root), mode],
                           capture_output=True, text=True)
        if r.returncode:
            sys.exit(f"{name} ({root}) failed:\n{r.stderr[-3000:]}")
        m = json.loads(r.stdout.strip().splitlines()[-1])
        runs.append((name, m))
        if mode == "f32":
            print(f"{name}: f32 fast_math ViT-S/16 at batch 256 ({m['dtype']}): float step "
                  f"{m['float_ms']:.1f} ms, QAT step {m['qat_ms']:.1f} ms (steps "
                  f"{', '.join(f'{v:.1f}' for v in m['float_steps'])} / "
                  f"{', '.join(f'{v:.1f}' for v in m['qat_steps'])}); device ms by kernel, "
                  f"float {m['float_groups']}; QAT {m['qat_groups']}", flush=True)
            continue
        line = (f"{name}: serving {m['serve_ms']:.2f} ms per batch-256 forward, detection "
                f"{m['detect_ms']:.2f} ms per batch-8 forward ({m['detect_preset']})")
        if mode == "all":
            line += (f"; float step {m['float_ms']:.1f} ms, QAT step {m['qat_ms']:.1f} ms "
                     f"(steps {', '.join(f'{v:.1f}' for v in m['float_steps'])} / "
                     f"{', '.join(f'{v:.1f}' for v in m['qat_steps'])})")
        print(line, flush=True)
        print(f"{name}: device ms by kernel, serving {m['serve_groups']}; detection "
              f"{m['detect_groups']}", flush=True)
    print(json.dumps({"card": card.strip(), "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
