"""The KD + QAT training window: ``KDQATTrainer.train_epoch`` on
synthetic CIFAR-10 at the trainer's defaults, on one card.

Set-up builds the trainer from weights made on the card, switches QAT on,
and drives the first ``checked_steps`` steps through ``train_epoch`` (the
first call fills the teacher-logit cache); those steps are what the plain
reference follows. Then ``warmup_steps`` more, and the window: one
``train_epoch`` call whose loader yields batches until the deadline, ending
in a synchronize. A traced run then profiles ``tail_steps`` more.

The benchmark's own span around each step call gives the host's enqueue
time per step.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench.lib import inputs, trace as tr
from portbench.lib.common import log, phase
from portbench.reference import compare, plain_vit


class Feed:
    """The trainer's loader, continued across epochs: each ``train_epoch``
    call takes ``limit`` batches, or batches until ``deadline``."""

    def __init__(self, loader):
        self.loader = loader
        self.epoch = 0
        self.it = None
        self.limit: Optional[int] = None
        self.deadline: Optional[float] = None
        self.taken: List[np.ndarray] = []  # row indices of each batch, in order

    def set_epoch(self, epoch: int) -> None:  # the trainer's reshuffle hook: ours is continuous
        pass

    def _next(self):
        while True:
            if self.it is None:
                self.loader.set_epoch(self.epoch)
                self.it = iter(self.loader)
            try:
                return next(self.it)
            except StopIteration:
                self.it = None
                self.epoch += 1

    def __iter__(self):
        n = 0
        while True:
            if self.limit is not None and n >= self.limit:
                return
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                return
            batch = self._next()
            self.taken.append(batch["index"])
            n += 1
            yield batch


def arch_of(group: Dict[str, Any], act: str = "gelu") -> plain_vit.Arch:
    return plain_vit.Arch(
        embed_dim=group["hidden_size"], depth=group["num_hidden_layers"],
        num_heads=group["num_attention_heads"], mlp_dim=group["intermediate_size"],
        image_size=group["image_size"], patch_size=group["patch_size"],
        num_classes=group.get("num_labels", 0), act=group.get("hidden_act", act),
        pre_norm=group.get("pre_norm", False), patch_bias=group.get("patch_bias", True),
        eps=group.get("layer_norm_eps", 1e-6))


def shapes_of(group: Dict[str, Any]):
    """The model's parameters, ``(name, shape)``, as the reference lists
    them."""
    return plain_vit.param_shapes(arch_of(group))


def program_model(group: Dict[str, Any], device, **kw):
    """The program's model of ``group``'s registry entry, built on
    ``device`` (its own initial draws are overwritten by
    :func:`materialize`; building on the meta device instead costs ~10 s of
    lazy imports on the card's machine)."""
    from qat_vit_tpu_torch.models.registry import create_model

    with torch.device(device):
        return create_model(group["registry"], **kw)


def materialize(bundle, params: Dict[str, torch.Tensor]):
    """The program's model holding ``params`` (observers unset); its
    parameters must be exactly the ones the benchmark made."""
    module = bundle.module
    have = {n: tuple(p.shape) for n, p in module.named_parameters()}
    want = {n: tuple(p.shape) for n, p in params.items()}
    if have != want:
        raise ValueError(f"the program's parameters differ from the benchmark's: "
                         f"{sorted(set(have.items()) ^ set(want.items()))[:8]}")
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(params[name])
        for name, b in module.named_buffers():
            b.fill_(float("inf") if name.endswith("min_val") else float("-inf"))
    return bundle


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, device,
        t_start: float = None, plant=None) -> Dict[str, Any]:
    from qat_vit_tpu_torch.train.config import load_hparams
    from qat_vit_tpu_torch.train.trainer import KDQATTrainer

    cfg, tf = cell["config_file"], cell["traffic_file"]
    dev = torch.device(device)
    batch = int(tf["batch"])
    s_cfg, t_cfg = cfg, cfg["teacher"]

    # ---- inputs and weights, from the seed, on the device ----
    images, labels = inputs.cifar_like(int(tf["train_images"]), seed, 1, dev)
    phase("images made", t_start)
    data = {"train_images": images.cpu().numpy(), "train_labels": labels.cpu().numpy().astype(np.int32),
            "test_images": images[:batch].cpu().numpy(),
            "test_labels": labels[:batch].cpu().numpy().astype(np.int32)}
    phase("images copied to the host", t_start)
    student = program_model(s_cfg, dev, qat_wrapper=True, num_classes=s_cfg["num_labels"])
    teacher = program_model(t_cfg, dev, dtype=torch.bfloat16, num_classes=t_cfg["num_labels"])
    phase("architectures built", t_start)
    s_params = inputs.make_params(shapes_of(s_cfg), seed, 2, dev)
    t_params = inputs.make_params(shapes_of(t_cfg), seed, 3, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phase("weights drawn", t_start)
    materialize(student, s_params)
    materialize(teacher, t_params)
    del s_params, t_params
    phase("weights placed", t_start)

    hp = load_hparams(None)
    hp.update(tf.get("hparams", {}))
    hp.update(batch_size=batch, seed=int(seed), eval_batch_size=int(tf["teacher_batch"]),
              image_size=int(cfg["image_size"]), num_classes=int(cfg["num_labels"]))
    trainer = KDQATTrainer(hp, device=dev, data=data, student=student, teacher=teacher)
    del student, teacher
    phase("trainer built", t_start)
    trainer.enable_qat()
    phase("trainer built, QAT on", t_start)
    feed = Feed(trainer.train_loader)
    trainer.train_loader = feed
    if plant is not None:
        plant(trainer)

    spans: List[float] = []
    next_fn = trainer.next_step_fn

    def timed_next():
        fn = next_fn()

        def step(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            spans.append(time.perf_counter() - t0)
            return out

        return step

    trainer.next_step_fn = timed_next
    module = trainer.state.module
    p0 = {n: p.detach().clone() for n, p in module.named_parameters()}

    # ---- the checked steps through the window's own call ----
    losses, g1 = [], None
    for i in range(int(tf["checked_steps"])):
        feed.limit = 1
        m = trainer.train_epoch(0)
        losses.append(m["train_loss"])
        if i == 0:
            adam = trainer.state.optimizer.adamw
            # AdamW's first moment after one step is (1 - beta1) x the
            # gradient it got; a parameter with no moment got none
            g1 = {n: adam.state[p]["exp_avg"].detach().clone() / (1 - 0.9)
                  if "exp_avg" in adam.state.get(p, {}) else torch.zeros_like(p)
                  for n, p in module.named_parameters()}
    p3 = {n: p.detach().clone() for n, p in module.named_parameters()}
    phase("teacher logits cached, checked steps taken", t_start)
    checked_rows = list(feed.taken)
    feed.limit = int(tf["warmup_steps"])
    trainer.train_epoch(0)

    # ---- the window ----
    feed.limit = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    spans.clear()
    t0 = time.perf_counter()
    feed.deadline = t0 + seconds
    m = trainer.train_epoch(1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    feed.deadline = None
    window_s = t1 - t0
    n_steps = int(m["n_batches"])
    images_done = n_steps * batch
    host_spans = list(spans)
    if host_spans:
        log(f"host ms per step: median {1e3 * statistics.median(host_spans):.2f}, "
            f"{n_steps} steps, {1e3 * window_s / max(1, n_steps):.2f} ms a step")
    out: Dict[str, Any] = {
        "setup_s": t0 - t_start, "window_s": window_s, "steps": n_steps,
        "images": images_done, "finite": bool(np.isfinite(m["train_loss"])),
        "host_spans": host_spans,
    }

    if trace:
        feed.limit = int(tf["tail_steps"])
        out["trace"] = tr.profile(torch, lambda: trainer.train_epoch(2), int(tf["tail_steps"]))
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                                else 0)

    # ---- free the program's state, then the reference ----
    del trainer, module, feed, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    out["compared"] = reference_check(cell, seed, dev, images, labels, checked_rows,
                                      losses, g1, p0, p3, hp)
    log(f"reference check: {time.perf_counter() - t_ref:.2f} s")
    return out


def reference_check(cell, seed, dev, images, labels, rows, losses, g1, p0, p3, hp):
    """The plain reference over the checked steps' rows from the same
    weights, against the program's losses, first gradient and change."""
    cfg = cell["config_file"]
    readings = reference_readings(cfg, seed, dev, images, labels, rows, hp)
    log(f"losses: program {losses}, reference {readings['losses']}")
    delta = {n: p3[n] - p0[n] for n in p0}
    log(f"printed only: {compare.train_diagnostics(readings['losses'], readings['g1'], readings['delta'], losses, g1, delta)}")
    return compare.train_readings(readings["g1"], readings["delta"], g1, delta, cell["limits"])


def reference_readings(cfg, seed, dev, images, labels, rows, hp, num=plain_vit.Numerics(),
                       half_batch: bool = False):
    """The reference's losses, first clipped gradient and parameter change
    over the steps on ``rows`` (``half_batch``: a planted fault, the step
    on the first half of each batch)."""
    s_cfg, t_cfg = cfg, cfg["teacher"]
    # the QAT student as the trainer runs it: tanh-GELU under fast_math
    s_arch = dataclasses.replace(arch_of(s_cfg), act=cfg["training"]["activation"])
    t_arch = arch_of(t_cfg)
    P0 = inputs.make_params(shapes_of(s_cfg), seed, 2, dev)
    T = inputs.make_params(shapes_of(t_cfg), seed, 3, dev)
    ref_hp = {k: float(hp[k]) for k in ("weight_decay", "grad_clip_norm", "kd_alpha",
                                        "kd_temperature", "label_smoothing")}
    ref_hp["lr"] = float(hp["lr"]) * float(hp.get("qat_lr_scale", 0.5))
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        def teacher_logits(x):
            with torch.no_grad():
                return torch.cat([plain_vit.forward(T, x[i:i + 128], t_arch)
                                  for i in range(0, len(x), 128)])

        batches = []
        for r in rows:
            idx = torch.as_tensor(r, device=dev)
            if half_batch:
                idx = idx[: len(idx) // 2]
            batches.append((images[idx], labels[idx].long()))
        losses, g1, p3 = plain_vit.qat_steps(P0, teacher_logits, batches, s_arch, ref_hp, num)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    return {"losses": losses, "g1": g1, "delta": {n: p3[n] - P0[n] for n in P0}}

