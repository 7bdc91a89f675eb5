"""The int8 classification serving window: ``Int8Predictor.serve_stream``
over uint8 32x32 images, a pool drawn from the seed and cycled, at a fixed
batch; a closed loop (the predictor pulls the next batch when it has
queued the last).

Set-up makes the weights on the card, calibrates and converts them
(``ptq_convert`` over ``calib_batches`` x ``calib_batch`` images), builds
the predictor and serves ``warmup_batches``. A batch's latency runs from
when the predictor takes it to when its logits are on the host. The
benchmark's own span around the predictor's per-batch forward call gives
the host's time per batch. Once the window has closed a sample of the
finished batches, drawn from the seed, is checked against the plain
reference, which quantizes the same weights again from the same
calibration images.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench.drivers.train import arch_of, program_model, shapes_of
from portbench.lib import inputs, trace as tr
from portbench.lib.common import log, phase
from portbench.reference import compare, plain_vit


def timed(obj, attr: str, spans: List[float]) -> None:
    """Wrap ``obj.attr`` in the benchmark's span."""
    fn = getattr(obj, attr)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        spans.append(time.perf_counter() - t0)
        return out

    setattr(obj, attr, wrapper)


def sample_positions(n_done: int, k: int, seed: int) -> List[int]:
    rng = np.random.default_rng(seed % (2 ** 63))
    return sorted(rng.choice(n_done, size=min(k, n_done), replace=False).tolist())


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, device,
        t_start: float = None, plant=None) -> Dict[str, Any]:
    from qat_vit_tpu_torch.data.pipeline import preprocess_fn
    from qat_vit_tpu_torch.serve.calibrate import ptq_convert
    from qat_vit_tpu_torch.serve.predictor import Int8Predictor

    cfg, tf = cell["config_file"], cell["traffic_file"]
    dev = torch.device(device)
    b = int(tf["batch"])
    bundle = program_model(cfg, dev, qat_wrapper=True, num_classes=cfg["num_labels"])
    params = inputs.make_params(shapes_of(cfg), seed, 2, dev)
    phase("weights made", t_start)
    calib_u8, _ = inputs.cifar_like(int(tf["calib_batches"]) * int(tf["calib_batch"]), seed, 4, dev)
    prep = preprocess_fn(bundle.cfg.image_size)
    calib = [prep(c) for c in calib_u8.split(int(tf["calib_batch"]))]
    export = ptq_convert(params, calib, bundle.cfg, device=dev)
    phase("weights made, calibrated and converted", t_start)
    pred = Int8Predictor(export, bundle.cfg, batch_size=b, device=dev)
    phase("predictor built", t_start)
    pool_dev, _ = inputs.cifar_like(int(tf["pool_images"]), seed, 5, dev)
    pool = pool_dev.cpu().numpy()
    phase("images made", t_start)
    n_chunks = len(pool) // b
    if plant is not None:
        plant(pred)

    def chunk(k: int) -> np.ndarray:
        j = k % n_chunks
        return pool[j * b:(j + 1) * b]

    spans: List[float] = []
    timed(pred, "_forward", spans)

    def serve(n_batches: int = None, deadline: float = None):
        takes, outs, logits = [], [], []

        def source():
            k = 0
            while (n_batches is None or k < n_batches) and (
                    deadline is None or time.perf_counter() < deadline):
                takes.append(time.perf_counter())
                yield chunk(k)
                k += 1

        for out in pred.serve_stream(source()):
            outs.append(time.perf_counter())
            logits.append(out)
        return takes, outs, logits

    serve(int(tf["warmup_batches"]))
    phase("predictor warmed up", t_start)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    spans.clear()
    t0 = time.perf_counter()
    takes, outs, logits = serve(deadline=t0 + seconds)
    t1 = outs[-1] if outs else time.perf_counter()
    lat = [o - t for t, o in zip(takes, outs)]
    out: Dict[str, Any] = {
        "setup_s": t0 - t_start, "window_s": t1 - t0, "batches": len(outs),
        "images": len(outs) * b, "attempted": len(takes) * b,
        "latencies_s": lat, "host_spans": list(spans),
    }
    if trace:
        out["trace"] = tr.profile(torch, lambda: serve(int(tf["tail_batches"])),
                                  int(tf["tail_batches"]))
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    picks = sample_positions(len(logits), int(tf["check_batches"]), seed)
    got = torch.from_numpy(np.concatenate([logits[k] for k in picks]))
    del pred, export, logits
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    images = pool_dev[torch.as_tensor(np.concatenate(
        [np.arange((k % n_chunks) * b, (k % n_chunks + 1) * b) for k in picks]), device=dev)]
    t_ref = time.perf_counter()
    want = reference_logits(cfg, seed, dev, calib_u8, int(tf["calib_batch"]), images)
    log(f"reference check: {time.perf_counter() - t_ref:.2f} s")
    out["compared"] = compare.outputs_readings({"logits": got}, {"logits": want}, cell["limits"])
    return out


def reference_logits(cfg, seed, dev, calib_u8, calib_batch, images, bits: int = 8):
    """The reference's logits for ``images`` (uint8): the same weights
    quantized again from the same calibration images, the int8 forward."""
    arch = arch_of(cfg)
    P = inputs.make_params(shapes_of(cfg), seed, 2, dev)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        calib = [plain_vit.preprocess(c, arch.image_size) for c in calib_u8.split(calib_batch)]
        ex = plain_vit.ptq_export(P, calib, arch)
        outs = [plain_vit.int8_forward(P, ex, plain_vit.preprocess(images[i:i + 256], arch.image_size),
                                       arch, serve_act=cfg["serving"]["activation"], bits=bits)
                for i in range(0, len(images), 256)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return torch.cat(outs).cpu()
