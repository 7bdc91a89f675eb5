#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``qat_vit_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero with no result):

1. environment: the card's name and power limit (nvidia-smi), torch/CUDA
   versions, and the time to build the kernels from ``qat_vit_tpu_torch/csrc``;
2. kernels against their plain PyTorch versions on the card, at ViT-S/16
   shapes with batch 32 (the int8 GEMMs, K3 and kernels A and B also at the
   main paths' batch 256, the GEMMs also at K 480, K = 32 mod 64, each
   GEMM identical and beside ``torch._int_mm`` by device time too; kernels
   A and B also at N 512, past their old shared-memory
   plans, with 6 heads of 64 and of 128), each timed (CUDA events around one call, median
   of 30 runs after warm-up; the kernel also as the mean of 10 back-to-back
   calls, printed beside it) beside its plain version (the slow plain
   versions of the attention kernels: the one run that the check makes);
3. serving: a random-init ViT-S/16 student (224 px, 10 classes), PTQ over
   4 calibration batches of 32, then ``Int8Predictor`` on 512 uint8 32x32
   images at batch 256 through the kernels; checks the kernels' launch
   counts, finite logits, identity with the plain chain with K3 as its
   attention stage (each call within the int8 bound), the distance to the
   plain chain (``CHAIN_REL_L2``) and to the exact f32 path, prints the
   serving img/s and profiles one batch-256 forward (device time by kernel
   group: 12 K3, 14 K2a and 12 K2b kernels, no K7 kernel);
4. training: ``KDQATTrainer`` at full ViT-S/16 geometry under the trainer's
   defaults (bf16, fast_math, fq_in_kernel) with a random-init ViT-B/16
   teacher, on 1,024 synthetic CIFAR-10 images: 3 float steps, the QAT
   switch and 3 QAT steps at batch 32, each run from the same state through
   the kernels, through kernel A with kernel B's plain version and through
   the plain versions (``REPLAY_*``, ``VIT_REPLAY_*``), then at batch 256
   (teacher logits cached, launch counts of both attention kernels in both
   phases, 12 each per step, finite losses, train img/s per phase, one more
   step per phase under torch.profiler: 12 kernel A kernels and 12 of each
   of kernel B's two passes), QAT eval, int8 convert and int8 eval through
   the serving kernels;
5. detection: a random-init OWLv2-pruned detector (768 px, D 576, depth 9,
   9 heads, 2,305 tokens, quick-GELU) calibrated on 2 seeded images and
   converted; the long attention kernel's two entry points (K5a's bf16
   output, K6a's int8 output) and the GEMM kernels against their plain
   versions at its shapes (batch 2); then int8 detection at batch 8 with 4
   queries through the serving preset (``megamodel_long``: the K6 chain),
   with its launch counts, the outputs against the same chain through the
   plain versions (batch 2; printed with the 2e-2 chain bound, not held),
   identical to the plain chain with the kernels' attention stage (each of
   its calls within K6a's int8 bound), against the exact f32 path, the median ms
   per forward and one profiled forward (device time by kernel group, the
   idle share); last, the exact path with ``attn_impl="pallas_long"`` (K5a)
   at batch 2;
6. detection training: the long attention forward (K5a) and backward (K5b,
   timed with the forward's output and log-sum-exp given, as training calls
   it) against their plain versions at the shapes the main path below gives
   them (``[16, 2305, 1728]``); ``DetectKDTrainer`` (the OWLv2-pruned
   student from a random-init bf16 OWLv2-base teacher, 768 px, 4 queries
   per image, the trainer's defaults) with depth cut to 2 at batch 2: 2
   float steps, the QAT switch and 2 QAT steps, each run from the same
   state through the kernels and through the plain versions (the loss, the
   gradient, the update and the parameters after the step held to fixed
   limits, ``DT_REPLAY_*``); then
   the main path at full depth and batch 16: the teacher-output cache over
   64 synthetic CIFAR-10 images, 3 float steps, the switch, 3 QAT steps
   (launches of K5a and K5b per step, ms per step and img/s with the first
   step apart, peak device memory, and one more step of each phase under
   torch.profiler: device time by kernel group and the idle share), int8
   convert and int8 eval against the fake-quant detector;
7. the rest of int8 serving on phase 3's ViT-S/16 export: the fused
   quantize GEMM (K7, TMA + ``wgmma`` in ``int8_gemm_wgmma.cu``, given the
   packed weight as ``quantized_dense`` passes it) identical to its plain
   version, two launches identical, at the exact path's batch-32 shapes and
   at K 96 and 480 and a ragged M (f32 and bf16 input, per-tensor and
   per-channel), the
   scale-after-dot attention (K8: f32 on ``attention_f32.cu``, bf16 on the
   tensor cores in ``attention_q_mma.cu``) at ``[32, 197, 1152]`` in f32
   and bf16, with masked keys, and at ViT-S/16's 577 tokens at 384 px
   (``[8, 577, 1152]``) in both, and the whole-block kernels (K9a, K9b)
   at batch 32 identical to their plain twin (the chain through the plain
   ops with K3 as its attention stage) and to the megamodel kernel chain,
   and at ViT-S/16's 901 tokens at 480 px (batch 8, a calibrated 480 px
   export) identical to the kernel chain; the exact path with
   ``use_pallas=True, attn_impl="pallas"`` (49 K7 and 12 K8 launches,
   identical to the same path through the plain K7/K8, within
   ``EXACT_REL_L2`` of the exact path); ``mixed_none`` + ``pallas_fused``
   against its ``*_plain`` twin with K3's attention and ``mixed`` +
   ``pallas`` against its ``*_plain`` twin with K8's attention (each call
   held by ``compare_tc``) and within ``MIXED_CHAIN_REL_L2`` of the
   all-plain twin; then ``megablock:4:tight`` and
   ``megamodel_res:4:tight`` at batch 256 (12 and 1 cooperative launches,
   none of the chain's attention, GELU_Q or RESID_LN_Q kernels, logits
   bit-identical to the megamodel kernel chain over two launches, within
   ``CHAIN_REL_L2`` of the all-plain chain) with the ms per forward of all
   three, in turns;
8. kernel forms: K6's int8 score dots (the ``i8`` flag), the qkv GEMM's
   PLAIN_Q8 epilogue and ``attention_long_q8`` at ``[2, 2305, 1728]``, and
   the f32 forms of kernels A and B (``csrc/attention_f32.cu``; ViT-S
   ``[8, 197, 1152]`` and ``[256, 197, 1152]``, N 512 with 6 heads of 64
   and of 128, N 1,248 with one head of 128, with and without the
   in-kernel fake-quant; two launches identical, kernel B's STE zero set
   the plain version's, device ms beside SDPA's; one kernel-B call
   profiled must show its rows and keys kernels) and of K5a / K5b
   (``[2, 2305, 1728]``; K5a, kernel A's f32 kernel, also at 7,000 tokens,
   past the earlier kernel's plan; K5b, kernel B's f32 passes with K5b's
   arithmetic, also at 4,096 tokens with padded queries; two launches
   identical), each bit-identical to its plain version
   (``attention_long_q8``: K6a's int8 bound); the ``i8`` chain on phase 5's
   export at batch 8 x 4 queries (47 launches; against its plain twin
   printed, not held; identical to the plain twin with the kernels'
   attention stage; within the detection bounds of the exact path, ms per forward beside
   ``megamodel_long`` in turns); one float and one QAT step
   of ViT-S and of OWLv2-pruned in f32 with fast_math, depth 2, batch 2,
   through the kernels and through ``reference_impl()``: identical;
9. checkpoints: phase 3's export through ``save_checkpoint`` and
   ``Int8Predictor.from_checkpoint`` (logits identical, K2d launched),
   phase 4's student and teacher written to files and read back by a new
   trainer (identical);
10. entry points, on synthetic CIFAR-10 (50,000 / 10,000 images): the
   training CLI (``python -m qat_vit_tpu_torch.train.trainer``, a child
   process) with a ViT-S/16 student and a random-init ViT-B/16 teacher for
   2 epochs of 4 steps at batch 256 (QAT from epoch 1, one profiled QAT
   epoch): exit 0, the artifact set, a finished tracker run with the
   reference's metric names, the int8 export served by
   ``Int8Predictor.from_checkpoint`` at batch 256, kernels A and B by name
   in the trace; the CLI again with ``--resume`` (epoch 2 only); a trainer
   at batch 32 that loads another's resume file after a QAT step
   (parameters, observers and AdamW state identical, and one more step of
   each identical); ``observer_interval`` 4 over 8 QAT steps at batch 256
   (observers move at steps 1 and 5 only, 12 fused kernel-A calls then, 12
   unfused ones in the frozen steps; ms per observing and frozen step) and
   ``observer_stride`` 4; the detection CLI (``--task detection``,
   OWLv2-pruned at 768 px, batch 4, eval batch 8) in this process, K5a and
   K5b launched, its int8 export read back; the native data loader used;
11. data parallelism (``torch.distributed``): the package's dry run
   (``parallel/dryrun.py``, two ranks, micro models); two ranks of this
   script sharing the card over gloo (and, with two cards or more, on
   NCCL with a card each): ViT-S/16 from a bf16 ViT-B/16 at 128 images a
   rank, 3 float, 3 observing QAT and 1 frozen QAT DP steps, then
   OWLv2-pruned at depth 2, 8 images a rank, one float and one QAT DP step,
   each against one process's step on the global batch from the same
   state (loss, gradient norm, parameters, observers held to
   ``DP_LIMITS`` / ``DP_DET_LIMITS``, the ranks identical), the DP steps'
   ms and global img/s, the kernels' launches and one profiled QAT DP step
   per rank (12 kernel A, 12 + 12 kernel B kernels), K5a / K5b launched;
   a world of one on NCCL, one QAT step through DDP identical to the step
   without it; the training CLI under ``torchrun`` on two ranks (exit 0,
   rank 0 alone writes the files, the same epoch metrics on both ranks)
   and its export through ``Int8Predictor`` with a replica per device,
   identical to one device;
12. the TPE search, evaluation and the model tail: ``run_optuna_search``
   (ViT-S/16 at 224 px from a random-init ViT-B/16, 3 trials of 3 epochs of
   2 steps at batch 64, the in-repo TPE): every trial COMPLETE and FINISHED,
   trial k's student from seed k, the teacher built once and shared, kernel
   A and B launches in every float and QAT epoch, no teacher row filled
   twice, the memory allocated after the last trial within 5% of after the
   first, ``best_params.yaml`` read back, the summary run; the search CLI in
   a child process; the ``--task detection`` search (OWLv2-pruned at 768
   px, 2 trials, K5a and K5b launched, its metrics tracked); ``remat``
   none / dots / full at batch 256 (a float and then a QAT step on a fresh
   trainer: every loss, gradient, parameter and observer identical to
   none's, and to a second none trainer's; 12 / 12 / 24 kernel A and 12 +
   12 kernel B kernels in a profiled QAT step; peak memory and ms per
   step); the evaluator CLI on none's QAT student (every observer finite)
   and phase 10's ``best_converted`` (fake-quant, int8 exact, int8 preset;
   img/s), the preset's count identical to
   ``Int8Predictor.from_checkpoint``'s, one profiled preset batch naming
   K2a-d and K3, the evaluator as a child process, the comparator with a
   teacher row and no error row; ``get_model_complexity`` and the HF
   entries.
   Phase 12 runs in a child process of the script (``--phase-12-child``),
   where torch.profiler has profiled nothing before. ``python3
   chip_smoke.py --phase-12`` runs the build, phase 10's training CLI (for
   its artifacts) and phase 12 alone;
13. tensor parallelism (``parallel/tensor.py``): two ranks of this script
   (``--tp-rank JOB``) sharing the card over gloo as a (data 1, model 2)
   rank grid, ``KDQATTrainer`` with ``model_parallel`` 2 on ViT-S/16 at full
   width, depth 12, 224 px, from a bf16 ViT-B/16 (the einsum attention, as
   under JAX's model axis): one float and one observing QAT step on a
   global batch of 32, each split over the two ranks against one process's
   step from the same whole state (loss, gradient norm, gathered parameters,
   every observer, the first block's qkv weight gradient held to
   ``TP_LIMITS`` from ``port_scripts/tp_bounds.py``; weight observers and
   the ranks identical), each rank's shard shapes, the TP and one-process
   steps' ms; with four cards also a (data 2, model 2) grid on NCCL, else a
   line saying it was not run; the training CLI under ``torchrun`` with
   ``--model-parallel 2`` (exit 0, rank 0 alone writes, the same epoch
   metrics on both ranks), its ``best_qat`` loaded strictly into one
   process's model, its resume file into a one-process trainer (one more
   QAT step), its export served by ``Int8Predictor`` (K3 launched).
   ``python3 chip_smoke.py --phase-13`` runs the build and phase 13 alone.

The bf16 long attention pair (K5a ``attention_long_mma``, K5b
``attention_long_bwd_mma``, phases 5 and 6), the bf16 kernels A
(``attention_q_mma``) and B (``attention_bwd_mma``, phase 2) and the bf16
K8 (``attention_q_mma``, phase 7) sum on the tensor cores: each is held to ``compare_tc``'s tolerance against its plain
version and to the plain version's own error against the f64 math, and
two of its launches on the same inputs must be identical; kernel B's STE
zero set must be the plain version's. K6a (``attention_long_q_mma``, both score
forms, phases 5 and 8) and K3 (``attention_q_mma``, phase 2) sum there too
and use the card's ``ex2``: their int8 outputs are held to at most one step
off and ``INT8_MIN_EXACT`` identical against the index-order plain
versions, two launches identical. A chain amplifies every such flip
(``port_scripts/k6_chain_check.py``, ``k3_chain_check.py``), so the chains
through K3 or K6a are held to the plain chain with the kernel as its
attention stage (identical) and to the exact f32 path's bounds; their
distance to the plain chain is held where a limit separates sound
attentions from planted faults (``CHAIN_REL_L2``, ``LONG_CHAIN_REL_L2``)
and printed otherwise. Every other kernel and form must be identical to
its plain version.

Every kernel check also records the kernel's bound (the larger of its
operations over the H100's peak for their type and its bytes over 3.35
TB/s) and, where one PyTorch call computes the same function, that call's
time. The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Needs a CUDA device; with none it exits 2.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
B_KERNEL = 32  # batch of the phase-2 kernel checks
CALIB_BATCHES, CALIB_B = 4, 32
N_IMAGES, SERVE_B = 512, 256
TIMING_RUNS = 30
# printed beside a kernel's time (one call per pair of CUDA events, which
# also counts the ~0.05 ms the Python wrapper takes while the card waits):
# the mean over this many back-to-back calls, where a wrapper's host work
# overlaps the previous call's device work as in the serving chains
KERNEL_REPS = 10
# int8 outputs: a rounding-boundary flip (op order, tanh/exp ulps) may move
# an element by one step; at least this share must be exact
INT8_MIN_EXACT = 0.999
# a chain of int8 blocks through the kernels vs through their plain versions
# (logits rel L2). A tensor-core attention (K3, K6a) flips int8 outputs near
# a rounding midpoint and the chain amplifies each flip, so a chain is held
# identical to the plain chain with the kernel as its attention stage, and
# the distance to the plain chain where a limit separates sound attentions
# from planted faults, in readings of the same chain on the H100 (PERF.md §2):
# - ViT-S (phase 3, K3): logits within 4e-2; port_scripts/k3_chain_check.py
#   at batch 256 read sound attentions 3.1e-3-2.04e-2 (K3 2.038e-2, exp2 p
#   1.655e-2, 16-dim score chunks 9.47e-3, 16-key p.v chunks 8.00e-3, one
#   flipped output 3.14e-3) and planted faults 8.07e-2-3.84e-1 (the last
#   key tile dropped 8.07e-2, block 0 one step up 1.46e-1, a head zeroed
#   3.84e-1);
# - OWLv2-pruned's K6 chain (phase 5, K6a): logits within 3.2e-2, between
#   the readings of port_scripts/k6_chain_check.py at batch 2 (sound
#   attentions 2.44-2.94e-2, planted faults 3.54-3.88e-2); the i8 chain
#   (phase 8), which that control does not read, is printed against it;
# - ViT-S's mixed + pallas chain (phase 7, the bf16 K8): logits within
#   3e-2 of the all-plain twin; port_scripts/k8_chain_check.py at batch 32
#   read sound attentions 0-1.927e-2 (K8 1.927e-2, exp2 p 1.823e-2, 16-dim
#   score chunks 1.039e-2, 16-key p.v chunks 8.66e-3) and planted faults
#   4.768e-2-3.778e-1 (block 0 one bf16 step up 4.768e-2, the last key
#   tile dropped 8.005e-2, scores scaled twice 8.943e-2, a head zeroed
#   3.778e-1).
CHAIN_REL_L2 = 4e-2
LONG_CHAIN_REL_L2 = 3.2e-2
MIXED_CHAIN_REL_L2 = 3e-2
# megamodel chain (bf16 stream, tanh-GELU, multiply-quantize) vs the exact
# f32 path (erf-GELU, divide-quantize): ~2.5e-2 on the micro model
EXACT_REL_L2 = 0.2
N_TRAIN, N_TEST = 1024, 512
# phase 9: the images the teacher read back from its .pth is held on
CKPT_TEACHER_IMAGES = 64
TRAIN_B, REPLAY_B, TRAIN_STEPS = 256, 32, 3
# a train step through the attention kernels vs through their plain
# versions, from the same state: the loss (float steps) and the parameters
# after the step (one bf16 step, 2^-8, in a few activations moves a KD loss
# of ~1 by < 1e-3)
REPLAY_LOSS_REL = 1e-3
REPLAY_PARAM_REL_L2 = 1e-2
# phase 4's replay: each step run from the same state through the kernels,
# through kernel A with kernel B's plain version (the hybrid) and through
# the plain versions. Both kernels sum on the tensor cores, so the step
# moves: held are the float loss (REPLAY_LOSS_REL) and the parameters
# (REPLAY_PARAM_REL_L2) against the plain step, in float steps the gradient
# on the qkv weights against the plain step's (VIT_REPLAY_QKV_GRAD_REL), and
# in every step that gradient against the hybrid's, which sees kernel B
# alone (VIT_REPLAY_QKV_GRAD_HYBRID_REL, float and QAT). The limits lie
# between readings of port_scripts/replay_bounds.py --vit on the H100 over
# eight seeds (PERF.md §2):
# - against the plain step, float steps: at most 8.72e-3 for sound
#   attention (the kernels; kernel A replaced by the exact f64 forward;
#   kernel B by the exact f64 backward), at least 3.28e-2 for a planted
#   fault (kernel B's dk zeroed on one 64-key tile; dv 3.12e-1; kernel A's
#   k and v of one 64-key tile zeroed 2.80e-1, one head's output 2.01e-1);
# - against the hybrid: at most 6.41e-3 (float) / 5.68e-3 (QAT) sound (the
#   kernels; kernel B replaced by the exact backward), at least 3.27e-2 /
#   3.17e-2 for dk zeroed on one tile (dv: 3.12e-1 / 3.41e-1).
# Neither separates the exact backward of qkv rounded to float8 (4.33e-3 /
# 5.06e-3 against the hybrid: inside the sound range). Printed, not held:
# the QAT loss and the QAT steps' qkv gradient against the plain step,
# where the fake-quant roundings that a sound attention moves already move
# the gradient by up to 2.50e-1 (faults from 1.72e-1).
VIT_REPLAY_QKV_GRAD_REL = 3e-2
VIT_REPLAY_QKV_GRAD_HYBRID_REL = (1.5e-2, 1.5e-2)
# int8 detection: the preset's batch and queries (the reference's detection
# bench), calibration images, the plain chain's batch, timing runs
DET_B, DET_Q, DET_CALIB, DET_REF_B, DET_TIMING_RUNS = 8, 4, 2, 2, 10
# against the exact f32 path: the JAX package's int8-vs-fake-quant detection
# bounds (tests/test_owlv2_detect.py)
DET_BOX_MEAN_ERR, DET_CORR = 0.03, 0.97
# detection training: the batch of the detection QAT step (ROADMAP.md Queue 1
# item 10), steps per phase, the replay's batch, steps and depth, the
# synthetic images behind the teacher cache, the eval batch and batches
DT_B, DT_STEPS, DT_REPLAY_B, DT_REPLAY_STEPS, DT_REPLAY_DEPTH = 16, 3, 2, 2, 2
DT_N_TRAIN, DT_EVAL_B, DT_EVAL_BATCHES = 64, 16, 2
# phase 7: timing runs of each serving mode's forward; K8's batch and tokens
# at ViT-S/16's 384 px (past the earlier kernel's plan)
SERVE_MODE_RUNS = 10
K8_B384, K8_N384 = 8, 577
# phase 7: K9's batch at ViT-S/16's 480 px (901 tokens, past the CUDA-core
# attention tile's 789 that K9 ran before)
K9_B480 = 8
# phase 8: K5a in f32 past the earlier kernel's plan (6,048 tokens at hd 64)
K5A_LONG_N = 7000
K5B_CAP_N = 4096  # JAX's cap on the training pair
# phase 6's replay: each step run from the same state through the kernels,
# through K5a with K5b's plain version (the hybrid: the same forward) and
# through the plain versions. The bf16 long pair sums on the tensor cores,
# so no metric is 0. Held: the loss against the plain step in float steps
# (REPLAY_LOSS_REL), the parameters after every step (REPLAY_PARAM_REL_L2),
# and the gradient on the qkv weights, the first that K5b's output reaches,
# against the hybrid step (DT_REPLAY_QKV_GRAD_REL). That limit lies between
# readings of port_scripts/replay_bounds.py on the H100 over eight seeds
# (PERF.md §2): at most 1.29e-3 for sound attention (the kernels; K5a with
# the exact f64 backward), at least 5.83e-3 for a planted fault (K5b's dk or
# dv zeroed on one key tile of 64; the exact backward of float8 qkv).
# Printed only, no criterion: the loss under QAT, where no limit lies
# between sound and faulty readings (exact attention moves it by up to
# 1.03e-2, zeroing a head's output by as little as 4.9e-4; the qkv gradient
# against the hybrid guards that step); the whole gradient and the update,
# where a planted fault hides in the noise.
DT_REPLAY_QKV_GRAD_REL = 3e-3

# the bf16 kernels K3, A and K8 on the tensor cores, and the f32 kernels A
# and B (the f32 K5a and K8 run kernel A's)
SHORT_MMA_ATTENTION = "qat_vit_tpu_torch/csrc/attention_q_mma.cu"
F32_ATTENTION = "qat_vit_tpu_torch/csrc/attention_f32.cu"
# the kernel group of K7 (csrc/int8_gemm_wgmma.cu's quantize_gemm_kernel),
# which serving never launches; K2a and K2b run the same file's int8 kernel
K7_GROUP = "K7"
WGMMA_GEMM = "qat_vit_tpu_torch/csrc/int8_gemm_wgmma.cu"

# H100 SXM dense peaks (NVIDIA's H100 datasheet): operations per second by
# type, and the device memory's bytes per second
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, runs: int = TIMING_RUNS, warmup: int = 3, reps: int = 1) -> float:
    """The median over ``runs`` samples of the CUDA-event time of ``reps``
    back-to-back calls of ``fn``, per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_group(name: str) -> str:
    """The bucket of a device kernel in the detection training breakdown."""
    n = name.lower()
    for key, group in (("long_bwd_rows_mma", "K5b rows"), ("long_bwd_keys_mma", "K5b keys"),
                       ("long_attention_mma", "K5a"), ("long_attention_q_mma", "K6a"),
                       ("long_attention_f32_bwd_rows", "K5b f32 rows"),
                       ("long_attention_f32_bwd_keys", "K5b f32 keys"),
                       ("gemm_resid_ln", "K2c RESID_LN_Q"),
                       ("int8_wgmma_kernel<1,", "K2b GELU_Q"),
                       ("int8_wgmma_kernel<3,", "K2a PLAIN_Q8"), ("int8_wgmma_kernel", "K2a PLAIN"),
                       ("quantize_gemm_kernel", K7_GROUP),
                       ("ln_quantize", "K2d LN"), ("attention_q_mma", "K3 / kernel A"),
                       ("attention_bwd_rows_mma", "kernel B rows"),
                       ("attention_bwd_keys_mma", "kernel B keys"),
                       ("attention_f32_bwd_rows", "kernel B f32 rows"),
                       ("attention_f32_bwd_keys", "kernel B f32 keys"),
                       ("attention_f32_fwd", "kernel A f32"), ("megablock", "K9")):
        if key in n:
            return group
    if any(k in n for k in ("gemm", "xmma", "cutlass", "sm90", "nvjet")):
        return "GEMMs (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def device_breakdown(torch, fn):
    """``fn()`` under torch.profiler: (device ms by kernel group, device busy
    ms, host wall ms, kernel launches, kernel launches by group); empty
    groups where the profiler saw no device activity."""
    import collections

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, counts, spans = collections.Counter(), collections.Counter(), []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            groups[kernel_group(e.name)] += e.time_range.elapsed_us() / 1e3
            counts[kernel_group(e.name)] += 1
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for s, e in sorted(spans):  # the union of the kernels' intervals
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return groups, busy / 1e3, wall * 1e3, len(spans), counts


def device_ms(torch, fn, runs=20):
    """The device time of one ``fn()``: the summed durations of the kernels it
    launches under torch.profiler, over ``runs`` calls (no host time)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / runs


def host_us(torch, fn, calls=300):
    """A wrapper's host time per call: ``time.perf_counter`` around each of
    ``calls`` calls with no synchronisation (the card keeps up with a small
    kernel, so each reading is the host's work), the median."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def compare_int8(name, got, want):
    import torch

    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    exact = float((diff == 0).float().mean())
    worst = int(diff.max())
    if worst > 1 or exact < INT8_MIN_EXACT:
        fail(f"{name}: int8 max |diff| {worst}, exact share {exact:.6f}")
    return float(worst), exact


@contextlib.contextmanager
def plain_ops_with(name, **fns):
    """``serve.int8_vit``'s plain ops ``name`` (``PLAIN_OPS``, the short
    chains' ``*_plain`` twins, or ``LONG_PLAIN_OPS``) with ``fns`` in place of
    theirs, for the block."""
    from types import SimpleNamespace

    from qat_vit_tpu_torch.serve import int8_vit

    old = getattr(int8_vit, name)
    setattr(int8_vit, name, SimpleNamespace(**{**vars(old), **fns}))
    try:
        yield
    finally:
        setattr(int8_vit, name, old)


@contextlib.contextmanager
def k3_in_plain_chain(fa):
    """Within the block, the short chains' plain ops (``megamodel_plain``,
    the ``*_plain`` per-GEMM chains) take K3 as their attention stage: each
    call runs the kernel and its plain version on the same inputs, holds the
    kernel to :func:`compare_int8` and returns the kernel's output. Yields the
    list of (max |diff|, identical share) per call. Such a chain equals the
    kernel chain exactly where every other op replays its plain version."""
    calls = []

    def attention(qkv, h, hd, *, out_q, quant_max=255.0, n_valid=None):
        got = fa.fused_attention_qkv(qkv, h, hd, out_q=out_q, quant_max=quant_max,
                                     n_valid=n_valid)
        calls.append(compare_int8("attention_q in the chain", got, fa.fused_attention_qkv_plain(
            qkv, h, hd, out_q=out_q, quant_max=quant_max, n_valid=n_valid)))
        return got

    with plain_ops_with("PLAIN_OPS", attention=attention):
        yield calls


def k9_with_k3(fa, bk, plain):
    """K9's plain version ``plain`` (the chain through ``bk.PLAIN_OPS``) with
    K3 as its attention stage, each call held to :func:`compare_int8`: K9
    runs K3's tile, so K9 equals this twin bit for bit."""
    from types import SimpleNamespace

    def attention(qkv, h, hd, *, out_q, quant_max=255.0, n_valid=None):
        got = fa.fused_attention_qkv(qkv, h, hd, out_q=out_q, quant_max=quant_max,
                                     n_valid=n_valid)
        compare_int8("attention_q in K9's twin", got, fa.fused_attention_qkv_plain(
            qkv, h, hd, out_q=out_q, quant_max=quant_max, n_valid=n_valid))
        return got

    def twin(*args, **kwargs):
        old = bk.PLAIN_OPS
        bk.PLAIN_OPS = SimpleNamespace(**{**vars(old), "attention": attention})
        try:
            return plain(*args, **kwargs)
        finally:
            bk.PLAIN_OPS = old

    return twin


def k9_at_480(torch, fa, bk, ctx):
    """K9a and K9b at ViT-S/16's 901 tokens (480 px), batch 8, past the 789
    tokens of the attention tile K9 ran before: on a 480 px export (phase
    3's seed, calibrated on the same 8 images), ``megablock:4:tight`` and
    ``megamodel_res:4:tight`` logits identical to the megamodel kernel
    chain, 12 and 1 launches."""
    from qat_vit_tpu_torch.data.pipeline import preprocess_fn
    from qat_vit_tpu_torch.models.registry import create_student
    from qat_vit_tpu_torch.serve.calibrate import ptq_convert
    from qat_vit_tpu_torch.serve.int8_vit import export_to_device, int8_apply

    dev = torch.device("cuda")
    bundle = create_student("vit", generator=torch.Generator().manual_seed(SEED), device=dev,
                            image_size=480)
    cfg = bundle.cfg
    prep = preprocess_fn(cfg.image_size, device=dev)
    x = prep(torch.from_numpy(ctx["images"][:K9_B480]))
    qp = export_to_device(ptq_convert(bundle.module.state_dict(), [x], cfg, device=dev), dev)
    del bundle
    preset = {"attn_dtype": torch.bfloat16, "compute_dtype": torch.bfloat16, "gelu_approx": True}
    chain = int8_apply(qp, x, cfg, fused="megamodel", **preset)
    for mode, wrapper, want in (("megablock:4:tight", bk.megablock_forward, cfg.depth),
                                ("megamodel_res:4:tight", bk.megamodel_res_forward, 1)):
        wrapper.launches = fa.fused_attention_qkv.launches = 0
        got = int8_apply(qp, x, cfg, fused=mode, **preset)
        torch.cuda.synchronize()
        n, n_attn = wrapper.launches, fa.fused_attention_qkv.launches
        print(f"phase 7 {mode} at ViT-S/16 480 px ({cfg.seq_len} tokens), batch {K9_B480}: "
              f"{n} cooperative launches, logits identical to the megamodel kernel chain "
              f"{torch.equal(got, chain)}", flush=True)
        if n != want or n_attn or not torch.equal(got, chain) or not torch.isfinite(got).all():
            fail(f"{mode} at 480 px: {n} launches (expected {want}), chain attention {n_attn}, "
                 f"identical to the kernel chain {torch.equal(got, chain)}")


@contextlib.contextmanager
def k8_in_plain_chain(fa, la):
    """Within the block, the short chains' plain twins take the bf16 K8 as
    their float attention stage (``attn_impl="pallas"``): each call runs the
    kernel and its plain version on the same inputs, holds the kernel by
    :func:`compare_tc` against the plain version and the f64 math and
    returns the kernel's output. Yields the list of worst |diff| per call."""
    from qat_vit_tpu_torch.serve import int8_vit

    calls = []
    plain = int8_vit.flash_attention_qkv_plain

    def attention(qkv, h, hd, *, n_valid=None):
        got = fa.flash_attention_qkv(qkv, h, hd, n_valid=n_valid)
        ref = la.long_attention_f64(qkv, h, hd, n_valid=n_valid)[0]
        calls.append(compare_tc("flash_attention in the chain", got,
                                plain(qkv, h, hd, n_valid=n_valid), ref, 1)[0])
        return got

    int8_vit.flash_attention_qkv_plain = attention
    try:
        yield calls
    finally:
        int8_vit.flash_attention_qkv_plain = plain


@contextlib.contextmanager
def kernel_attention_in_plain_chain(la):
    """Within the block, the long chains' plain ops (``*_plain`` serving
    modes) take K6a as their attention stage, held and returned as
    :func:`k3_in_plain_chain` holds and returns K3."""
    calls = []

    def attention(qkv, h, hd, *, out_q=None, quant_max=255.0, n_valid=None):
        got = la.long_attention_qkv(qkv, h, hd, out_q=out_q, quant_max=quant_max,
                                    n_valid=n_valid)
        calls.append(compare_int8("attention_long_q in the chain", got, la.long_attention_qkv_plain(
            qkv, h, hd, out_q=out_q, quant_max=quant_max, n_valid=n_valid)))
        return got

    def attention_q8(qk8, qkv, h, hd, *, out_q, quant_max=255.0, n_valid=None):
        got = la.long_attention_q8(qk8, qkv, h, hd, out_q=out_q, quant_max=quant_max,
                                   n_valid=n_valid)
        calls.append(compare_int8("attention_long_q8 in the chain", got, la.long_attention_q8_plain(
            qk8, qkv, h, hd, out_q=out_q, quant_max=quant_max, n_valid=n_valid)))
        return got

    with plain_ops_with("LONG_PLAIN_OPS", attention=attention, attention_q8=attention_q8):
        yield calls


def compare_float(name, got, want, rtol):
    import torch

    got, want = got.to(torch.float32), want.to(torch.float32)
    err = (got - want).abs()
    bound = rtol * (1.0 + want.abs())
    if not torch.isfinite(got).all() or bool((err > bound).any()):
        fail(f"{name}: max |diff| {float(err.max()):.3e} beyond rtol {rtol}")
    return float(err.max())


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def compare_tc(name, got, want, ref, sections):
    """A tensor-core kernel of the bf16 long pair against its plain version
    ``want`` and the f64 math ``ref``, by the pair's tolerance
    (``long_attention.tc_errors``) → (worst |diff|, one note per section)."""
    from qat_vit_tpu_torch.ops import long_attention as la

    ok, errs = la.tc_errors(got, want, ref, sections)
    notes = [f"{e['label']} worst |diff| {e['worst']:.3e} within 2^-7(1+|plain|) "
             f"{e['within']:.7f} rel L2 vs plain {e['rel']:.3e} (bound {la.TC_REL_L2} for "
             f"dq/dk/dv); vs f64 kernel {e['f64']:.3e} plain {e['plain_f64']:.3e} (ratio "
             f"{e['f64'] / e['plain_f64'] if e['plain_f64'] else float('nan'):.3f}, bound "
             f"{la.TC_F64_RATIO})" for e in errs]
    if not ok:
        fail(f"{name}: beyond the bf16 pair's tolerance ({'; '.join(notes)})")
    return max(e["worst"] for e in errs), notes


def ste_zeros(got, want, qkv, fq=None):
    """Kernel B's STE zero set against its plain version: (both 0 at every
    element where the straight-through mask of the raw ``qkv`` is off (the
    mask of ``fq``'s qs and range; none without ``fq``), the kernel's zeros
    elsewhere, the plain version's zeros elsewhere). Zeros elsewhere are
    sums that cancel exactly, a record."""
    import torch

    from qat_vit_tpu_torch.quant.fake_quant import ste_mask

    keep = (ste_mask(qkv, fq["qs"][0], fq["qs"][1], *fq["in_fq"]) if fq
            else torch.ones_like(qkv, dtype=torch.bool))
    same = bool((got[~keep] == 0).all()) and bool((want[~keep] == 0).all())
    return same, int(((got == 0) & keep).sum()), int(((want == 0) & keep).sum())


def rand_int8(torch, np, rng, dev, *shape):
    return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(dev)


def rand_layer(torch, np, rng, dev, k, n, per_channel=False, bias=True):
    """A random int8 GEMM layer of the export's layout (w_int8 [K, N]) with
    the packed copy export_to_device adds on the card (w_int8_t [N, K])."""
    w = np.clip(np.round(rng.normal(0, 20, (k, n))), -128, 127).astype(np.int8)
    ws = (torch.from_numpy(rng.uniform(1e-3, 3e-3, n).astype(np.float32)).to(dev)
          if per_channel else torch.tensor(0.002))
    return {
        "w_int8": torch.from_numpy(w).to(dev),
        "w_int8_t": torch.from_numpy(np.ascontiguousarray(w.T)).to(dev),
        "w_colsum": torch.from_numpy(w.astype(np.int32).sum(0, dtype=np.int32)).to(dev),
        "bias": (torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)).to(dev)
                 if bias else None),
        "w_scale": ws,
    }


def rand_ln(torch, np, rng, dev, n):
    return {"scale": torch.from_numpy(rng.normal(1, 0.2, n).astype(np.float32)).to(dev),
            "bias": torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32)).to(dev)}


# The work of each kernel, from its shapes: operations by type and bytes (each
# input read once, each output written once).

def gemm_work(m, k, n, out_bytes, extra_bytes=0):
    """An int8 GEMM [m, k] @ [k, n] with its int32 column sums, f32 bias and
    outputs of ``out_bytes`` per element (more inputs in ``extra_bytes``)."""
    return {"ops": 2 * m * k * n, "type": "int8",
            "bytes": m * k + k * n + 8 * n + m * n * out_bytes + extra_bytes}


def ln_work(m, n, in_bytes):
    """LayerNorm of [m, n] (~8 f32 operations per element) → int8."""
    return {"ops": 8 * m * n, "type": "f32", "bytes": m * n * in_bytes + m * n + 8 * n}


def attention_work(b, n, heads, hd, out_bytes=2, backward=False, in_bytes=2, op_type="bf16"):
    """Attention over the packed qkv (bf16 unless ``in_bytes`` says f32): 2
    products forward (4·N²·hd per head), 5 backward (s, dp, dq, dk, dv:
    10·N²·hd), at the rate of ``op_type`` (f32 products: the f32 rate)."""
    d = heads * hd
    if backward:  # qkv and do in, dqkv out, all of in_bytes
        return {"ops": 10 * b * heads * n * n * hd, "type": op_type,
                "bytes": in_bytes * (b * n * 3 * d + b * n * d + b * n * 3 * d)}
    return {"ops": 4 * b * heads * n * n * hd, "type": op_type,
            "bytes": in_bytes * b * n * 3 * d + out_bytes * b * n * d}


def roofline(*works):
    """(bound_ms, bound_by): the least time the card could take for the
    ``works`` together (operations of each type at its peak, one after
    another, against all their bytes)."""
    t_ops = sum(w["ops"] / PEAK_OPS[w["type"]] for w in works)
    t_bytes = sum(w["bytes"] for w in works) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def block_works(b, n, d, mlp, heads, hd):
    """The five stages of one K4 block (the chain's launches, or K9's
    stages): the qkv GEMM (bf16 out), the int8-out attention, proj and fc2
    RESID_LN_Q and fc1 GELU_Q."""
    m = b * n
    return [gemm_work(m, d, 3 * d, 2), attention_work(b, n, heads, hd, 1),
            gemm_work(m, d, d, 4 + 1, 2 * m * d + 8 * d), gemm_work(m, d, mlp, 1),
            gemm_work(m, mlp, d, 2 + 1, 4 * m * d + 8 * d)]


def chain_works(b, n, d, mlp, heads, hd, depth, patch_k, head_n=0):
    """The launches of one int8 forward through a K4 / K6 chain: the patch
    GEMM and entry LN, the blocks, and the head GEMM."""
    m = b * n
    works = [gemm_work(m - b, patch_k, d, 2), ln_work(m, d, 2)]
    works += block_works(b, n, d, mlp, heads, hd) * depth
    return works + ([gemm_work(b, d, head_n, 4)] if head_n else [])


# One PyTorch call computing the same function, timed beside the kernel as a
# yardstick (the port never calls it).

def int_mm(torch, x, layer):
    """``torch._int_mm`` on the GEMM's int8 operands (the product alone, no
    epilogue), or None where its shape rules (M > 16, K and N multiples of
    8) refuse them."""
    a = x.reshape(-1, x.shape[-1])
    w = layer["w_int8"]
    if a.shape[0] <= 16 or a.shape[1] % 8 or w.shape[1] % 8:
        return None
    w = w.t().contiguous().t()  # column-major [K, N]
    return lambda: torch._int_mm(a, w)


def _heads(qkv, heads, hd):
    b, n, _ = qkv.shape
    return qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)  # q, k, v: [B, H, N, hd]


def sdpa_forward(torch, qkv, heads, hd):
    """``F.scaled_dot_product_attention`` forward on the heads of ``qkv``."""
    q, k, v = _heads(qkv, heads, hd)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)


def sdpa_backward(torch, qkv, do, heads, hd):
    """The autograd backward of ``F.scaled_dot_product_attention`` on the
    heads of ``qkv`` for the output gradient ``do`` (dq, dk, dv)."""
    q, k, v = (t.contiguous().requires_grad_(True) for t in _heads(qkv, heads, hd))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    g = do.view(do.shape[0], do.shape[1], heads, hd).transpose(1, 2)
    return lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True)


def phase_kernels(torch, np, fs, fa, fat, la):
    """Each kernel against its plain version at ViT-S shapes, batch 32."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    n_tok, d, mlp, heads, hd = 197, 384, 1536, 6, 64

    def act_int8(*shape):
        return rand_int8(torch, np, rng, dev, *shape)

    def layer(k, n, per_channel=False):
        return rand_layer(torch, np, rng, dev, k, n, per_channel)

    def ln(n):
        return rand_ln(torch, np, rng, dev, n)

    in_q = {"scale": torch.tensor(0.02), "zero_point": torch.tensor(121.0)}
    out_q = {"scale": torch.tensor(8.0 / 255), "zero_point": torch.tensor(128.0)}
    gelu_q = {"scale": torch.tensor(4.0 / 255), "zero_point": torch.tensor(11.0)}
    bf16 = torch.bfloat16
    b = B_KERNEL
    x_bf16 = torch.from_numpy(rng.normal(0, 1.5, (b, n_tok, d)).astype(np.float32)).to(dev).to(bf16)
    x_f32 = torch.from_numpy(rng.normal(0, 1.5, (b, n_tok, d)).astype(np.float32)).to(dev)
    qkv = torch.from_numpy(rng.normal(0, 1.0, (b, n_tok, 3 * d)).astype(np.float32)).to(dev).to(bf16)
    do = torch.from_numpy(rng.normal(0, 1.0, (b, n_tok, d)).astype(np.float32)).to(dev).to(bf16)
    # the qkv fake-quant grid of the QAT phase; its ends clip ~3% of N(0, 1)
    fq = {"qs": torch.tensor([4.2 / 255, 127.0], dtype=torch.float32, device=dev),
          "in_fq": (0, 255)}
    m = b * n_tok
    attn_bwd = attention_work(b, n_tok, heads, hd, backward=True)
    cases = [
        # name, wrapper, plain, args, kwargs, replaces, work, library call[, extra]
        # the ViT-S GEMMs at batch 32 and at the serving path's batch 256, and
        # at K 480 (K = 32 mod 64), each held identical, with device times
        *gemm_cases(torch, fs, act_int8, layer, ln, x_bf16, x_f32, b, n_tok, d, mlp, in_q, out_q,
                    gelu_q),
        ("int8_gemm:plain head [32x384]@[384x10] per-channel", fs.int8_dense,
         fs.int8_dense_plain, (act_int8(b, d), layer(d, 10, per_channel=True), in_q),
         {"out_dtype": torch.float32}, "qat_vit_tpu/ops/fused_serve.py:57",
         gemm_work(b, d, 10, 4), None, {"exact": True}),
        *ln_quantize_cases(torch, np, fs, dev, out_q, (x_bf16, ln(d))),
        *short_attention_cases(torch, fa, la, qkv, heads, hd, out_q, fq),
        *kernel_b_cases(torch, fat, la, qkv, do, heads, hd, fq),
    ]
    # K3, kernel A and kernel B at the main paths' batch too: serving and
    # training launch them on [256, 197, 1152]
    qkv_main = torch.from_numpy(rng.normal(0, 1.0, (SERVE_B, n_tok, 3 * d)).astype(
        np.float32)).to(dev).to(bf16)
    do_main = torch.from_numpy(rng.normal(0, 1.0, (SERVE_B, n_tok, d)).astype(
        np.float32)).to(dev).to(bf16)
    cases += short_attention_cases(torch, fa, la, qkv_main, heads, hd, out_q, fq)
    cases += kernel_b_cases(torch, fat, la, qkv_main, do_main, heads, hd, fq)
    cases += gemm_cases(torch, fs, act_int8, layer, ln, qkv_main[..., :d].contiguous(),
                        qkv_main[..., d:2 * d].float().contiguous(), SERVE_B, n_tok, d, mlp,
                        in_q, out_q, gelu_q)
    # K = 32 (mod 64), which JAX's gates admit: K2a, K2b and K2c at K 480
    k32 = 480
    cases += [
        (f"int8_gemm:plain qkv K {k32} [{m}x{k32}]@[{k32}x{3 * k32}] per-channel", fs.int8_dense,
         fs.int8_dense_plain, (act_int8(b, n_tok, k32), layer(k32, 3 * k32, True), in_q),
         {"out_dtype": bf16}, "qat_vit_tpu/ops/fused_serve.py:57", gemm_work(m, k32, 3 * k32, 2),
         None, {"exact": True}),
        (f"int8_gemm:gelu_q fc1 K {k32} [{m}x{k32}]@[{k32}x{4 * k32}]", fs.int8_dense_gelu_q,
         fs.int8_dense_gelu_q_plain, (act_int8(b, n_tok, k32), layer(k32, 4 * k32), in_q, gelu_q),
         {}, "qat_vit_tpu/ops/fused_serve.py:70", gemm_work(m, k32, 4 * k32, 1), None,
         {"exact": True}),
        (f"int8_gemm:resid_ln_q K {k32} [{m}x{k32}]@[{k32}x{d}]", fs.int8_dense_resid_ln_q,
         fs.int8_dense_resid_ln_q_plain,
         (act_int8(b, n_tok, k32), layer(k32, d), in_q, x_bf16, ln(d), out_q),
         {"out_dtype": bf16}, "qat_vit_tpu/ops/fused_serve.py:87",
         gemm_work(m, k32, d, 2 + 1, 2 * m * d + 8 * d), None, {"exact": True}),
    ]
    # the bf16 kernels A and B past the old shared-memory plans, at N 512
    # (JAX's K1 gate admits 6 heads up to N 512): 6 heads of 64 and of 128
    for k_hd in (64, 128):
        k_qkv = torch.from_numpy(rng.normal(0, 1.0, (2, 512, 18 * k_hd)).astype(
            np.float32)).to(dev).to(bf16)
        k_do = torch.from_numpy(rng.normal(0, 1.0, (2, 512, 6 * k_hd)).astype(
            np.float32)).to(dev).to(bf16)
        cases += short_attention_cases(torch, fa, la, k_qkv, heads, k_hd, out_q, fq)[1:]
        cases += kernel_b_cases(torch, fat, la, k_qkv, k_do, heads, k_hd, fq)
    return check_kernels(torch, cases, "phase 2", slow_plain=(fat.attention_bwd_plain,))


# K2d's phase-2 shapes (rows, width): ViT-S at batch 32 and 256, the OWLv2-pruned
# detection forward's entry LN (batch 8 x 2,305 tokens x 576), ViT-B's and ViT-L's
# widths, one past the register form's plan and an odd width (the strided form)
LN_SHAPES = [(B_KERNEL * 197, 384), (SERVE_B * 197, 384), (8 * 2305, 576),
             (B_KERNEL * 197, 768), (B_KERNEL * 197, 1024), (B_KERNEL * 197, 1280),
             (B_KERNEL * 197, 385)]


def ln_quantize_cases(torch, np, fs, dev, out_q, first):
    """``check_kernels``' cases of K2d at ``LN_SHAPES`` in bf16 and f32: each
    identical to ``ln_quantize_plain``, two launches identical, the form the
    plan picks, device ms and the wrapper's host us per call. ``first``: the
    bf16 input and LN of the first shape (phase 2's ViT-S activations); the
    others come from their own seeded generator."""
    rng = np.random.default_rng(SEED + 16)
    cases = []
    for i, (m, n) in enumerate(LN_SHAPES):
        x32 = torch.from_numpy(rng.normal(0.3, 1.5, (m, n)).astype(np.float32)).to(dev)
        ln = rand_ln(torch, np, rng, dev, n)
        inputs = [(x32.to(torch.bfloat16), ln, "bf16"), (x32, ln, "f32")]
        if i == 0:
            inputs[0] = (first[0], first[1], "bf16")
        for x, ln, tag in inputs:
            vec, nv = fs.ln_quantize_plan(n, x.element_size(), fs.pointer_align(x))
            form = f"registers, {nv} x {vec} bytes a lane" if vec else "strided"
            cases.append((f"ln_quantize [{m}x{n}] {tag}", fs.ln_quantize, fs.ln_quantize_plain,
                          (x, ln, out_q), {}, "qat_vit_tpu/ops/fused_serve.py:105",
                          ln_work(m, n, x.element_size()), None,
                          {"exact": True, "repeat": True, "device": True, "host": True,
                           "note": f"form: {form};"}))
    return cases


def gemm_cases(torch, fs, act_int8, layer, ln, res_bf16, res_f32, b, n_tok, d, mlp, in_q, out_q,
               gelu_q):
    """``check_kernels``' cases of the ViT-S block and patch GEMMs at batch
    ``b`` (K2a qkv and patch, K2b fc1, K2c proj and fc2), each held
    identical to its plain version, timed on the device too, beside
    ``torch._int_mm`` on the same operands."""
    bf16 = torch.bfloat16
    m = b * n_tok
    x_qkv, l_qkv = act_int8(b, n_tok, d), layer(d, 3 * d)
    x_proj, l_proj = act_int8(b, n_tok, d), layer(d, d)
    x_fc1, l_fc1 = act_int8(b, n_tok, d), layer(d, mlp)
    x_fc2, l_fc2 = act_int8(b, n_tok, mlp), layer(mlp, d)
    x_patch, l_patch = act_int8(b, n_tok - 1, 768), layer(768, d)
    held = {"exact": True, "device": True}
    return [
        (f"int8_gemm:plain qkv [{m}x{d}]@[{d}x{3 * d}]", fs.int8_dense, fs.int8_dense_plain,
         (x_qkv, l_qkv, in_q), {"out_dtype": bf16},
         "qat_vit_tpu/ops/fused_serve.py:57", gemm_work(m, d, 3 * d, 2),
         int_mm(torch, x_qkv, l_qkv), held),
        (f"int8_gemm:resid_ln_q proj [{m}x{d}]@[{d}x{d}]", fs.int8_dense_resid_ln_q,
         fs.int8_dense_resid_ln_q_plain, (x_proj, l_proj, in_q, res_bf16, ln(d), out_q),
         {"out_dtype": torch.float32}, "qat_vit_tpu/ops/fused_serve.py:87",
         gemm_work(m, d, d, 4 + 1, 2 * m * d + 8 * d), int_mm(torch, x_proj, l_proj), held),
        (f"int8_gemm:gelu_q fc1 [{m}x{d}]@[{d}x{mlp}]", fs.int8_dense_gelu_q,
         fs.int8_dense_gelu_q_plain, (x_fc1, l_fc1, in_q, gelu_q), {},
         "qat_vit_tpu/ops/fused_serve.py:70", gemm_work(m, d, mlp, 1),
         int_mm(torch, x_fc1, l_fc1), held),
        (f"int8_gemm:resid_ln_q fc2 [{m}x{mlp}]@[{mlp}x{d}]", fs.int8_dense_resid_ln_q,
         fs.int8_dense_resid_ln_q_plain, (x_fc2, l_fc2, in_q, res_f32, ln(d), out_q),
         {"out_dtype": bf16}, "qat_vit_tpu/ops/fused_serve.py:87",
         gemm_work(m, mlp, d, 2 + 1, 4 * m * d + 8 * d), int_mm(torch, x_fc2, l_fc2), held),
        (f"int8_gemm:plain patch_embed [{m - b}x768]@[768x{d}]", fs.int8_dense,
         fs.int8_dense_plain, (x_patch, l_patch, in_q), {"out_dtype": bf16},
         "qat_vit_tpu/ops/fused_serve.py:57", gemm_work(m - b, 768, d, 2),
         int_mm(torch, x_patch, l_patch), held),
    ]


def kernel_b_cases(torch, fat, la, qkv, do, heads, hd, fq):
    """``check_kernels``' cases of the bf16 kernel B with ``in_fq`` off and
    on, held by :func:`compare_tc` against the f64 math of the same
    fake-quantized qkv and by its STE zero set (:func:`ste_zeros`)."""
    b, n_tok, _ = qkv.shape
    shape = f"[{b}x{n_tok}x{3 * heads * hd}] {heads} heads"
    work = attention_work(b, n_tok, heads, hd, backward=True)
    return [
        (f"attention_bwd{name} {shape}", fat.attention_bwd, fat.attention_bwd_plain,
         (qkv, do, heads, hd), kw, "qat_vit_tpu/ops/flash_attention_train.py:48", work,
         sdpa_backward(torch, qkv, do, heads, hd),
         {"tc": (lambda kw=kw: la.long_attention_f64(qkv, heads, hd, do, **kw)[1], 3),
          "ste": (qkv, kw)})
        for name, kw in (("", {}), (":in_fq+ste", fq))]


def short_attention_cases(torch, fa, la, qkv, heads, hd, out_q, fq):
    """``check_kernels``' cases of K3 (held to the int8 bound) and of kernel A
    with ``in_fq`` off and on (held by :func:`compare_tc`) on ``qkv``."""
    b, n_tok, _ = qkv.shape
    shape = f"[{b}x{n_tok}x{3 * heads * hd}] {heads} heads"
    attn_fwd = attention_work(b, n_tok, heads, hd)
    replaces = "qat_vit_tpu/ops/flash_attention.py:125"
    return [
        (f"attention_q {shape}", fa.fused_attention_qkv, fa.fused_attention_qkv_plain,
         (qkv, heads, hd), {"out_q": out_q}, replaces, attention_work(b, n_tok, heads, hd, 1),
         sdpa_forward(torch, qkv, heads, hd), {"int8_bound": True}),
        (f"attention_fwd {shape}", fa.attention_fwd, fa.attention_fwd_plain, (qkv, heads, hd),
         {}, replaces, attn_fwd, sdpa_forward(torch, qkv, heads, hd),
         k1a_tc(la, qkv, heads, hd)),
        (f"attention_fwd:in_fq {shape}", fa.attention_fwd, fa.attention_fwd_plain,
         (qkv, heads, hd), fq, replaces, attn_fwd, sdpa_forward(torch, qkv, heads, hd),
         k1a_tc(la, qkv, heads, hd, **fq)),
    ]


def k1a_tc(la, qkv, heads, hd, **fq):
    """``check_kernels``' extra of a bf16 kernel A case (in_fq with ``fq``):
    the f64 math it is held to, of the same fake-quantized qkv."""
    return {"tc": (lambda: la.long_attention_f64(qkv, heads, hd, **fq)[0], 1)}


def k5_tc(la, qkv, heads, hd, do=None, n_valid=None):
    """``check_kernels``' extra of a bf16 K5a (``do`` None) or K5b case: its
    tensor-core source and the f64 math it is held to."""
    if do is None:
        return {"source": "qat_vit_tpu_torch/csrc/attention_long_mma.cu",
                "tc": (lambda: la.long_attention_f64(qkv, heads, hd, n_valid=n_valid)[0], 1)}
    return {"source": "qat_vit_tpu_torch/csrc/attention_long_bwd_mma.cu",
            "tc": (lambda: la.long_attention_f64(qkv, heads, hd, do, n_valid=n_valid)[1], 3)}


def check_kernels(torch, cases, label, slow_plain=(), exact=False):
    """Each (name, kernel, plain, args, kwargs, replaces, work, library[,
    extra]) case: the kernel's output against its plain version's on the
    same inputs (``exact``: bit for bit), then both timed (a plain version in
    ``slow_plain`` by its one comparison call), the library call (None: no
    single call computes it) and the bound of ``work`` (one work, or a list
    of them done one after another). ``extra``: ``source`` (where the
    kernel is not its wrapper's usual one), ``int8_bound`` (K3, K6a: int8
    outputs held by :func:`compare_int8` even where ``exact``), ``tc`` (the f64 math and its
    number of output sections: a bf16 tensor-core kernel with float output,
    K5a / K5b or kernels A and B, held by :func:`compare_tc`; both kinds sum
    in their own order and must give identical bits over two launches) and
    ``ste`` (kernel B's qkv and fake-quant: its STE zero set must be the
    plain version's, :func:`ste_zeros`), ``exact`` (this case bit for bit),
    ``repeat`` (two launches must give identical bits, as with ``tc``),
    ``device`` (also the kernel's and the library call's device time under
    torch.profiler, :func:`device_ms`), ``host`` (also the wrapper's host us
    per call, :func:`host_us`) and ``note`` (printed as it is)."""
    bf16 = torch.bfloat16
    results = []
    for name, kernel, plain, args, kwargs, replaces, work, library, *extra in cases:
        extra = extra[0] if extra else {}
        got = kernel(*args, **kwargs)
        errs, notes = [], []
        if "tc" in extra or extra.get("int8_bound") or extra.get("repeat"):
            again = kernel(*args, **kwargs)
            same = (all(map(torch.equal, again, got)) if isinstance(got, tuple)
                    else torch.equal(again, got))
            notes.append(f"two launches identical {same};")
            if not same:
                fail(f"{name}: two launches on the same inputs differ")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(*args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"{name}: kernel gives {g.dtype}{tuple(g.shape)}, plain {w.dtype}{tuple(w.shape)}")
        if "ste" in extra:
            same, z_got, z_want = ste_zeros(got[0], want[0], *extra["ste"])
            notes.append(f"STE zero set identical {same} (other zeros: kernel {z_got}, plain "
                         f"{z_want});")
            if not same:
                fail(f"{name}: the STE zero set differs from the plain version's")
        if "tc" in extra:
            ref, sections = extra["tc"]
            worst, tc_notes = compare_tc(name, got[0], want[0], ref(), sections)
            errs.append(worst)
            notes.append("; ".join(tc_notes))
            got = want = ()
        for g, w in zip(got, want):
            if (exact or extra.get("exact")) and not extra.get("int8_bound") and not torch.equal(g, w):
                fail(f"{name}: not identical to its plain version (max |diff| "
                     f"{float((g.float() - w.float()).abs().max()):.3e})")
            if g.dtype == torch.int8:
                worst, share = compare_int8(name, g, w)
                errs.append(worst)
                notes.append(f"int8 exact {share:.7f}")
            else:
                # f32 out: same f32 ops in the same order; bf16 out: one bf16 ulp
                errs.append(compare_float(name, g, w, 2 ** -7 if g.dtype == bf16 else 1e-5))
        ms = median_ms(lambda: kernel(*args, **kwargs))
        ms_b2b = median_ms(lambda: kernel(*args, **kwargs), reps=KERNEL_REPS)
        if plain in slow_plain:
            plain_ms = start.elapsed_time(end)
        else:
            plain_ms = median_ms(lambda: plain(*args, **kwargs))
        library_ms = median_ms(library) if library is not None else None
        bound_ms, bound_by = roofline(*(work if isinstance(work, list) else [work]))
        lib = f"{library_ms:.4f} ms" if library is not None else "none"
        if extra.get("device"):
            dev_lib = f"{device_ms(torch, library):.4f}" if library is not None else "none"
            notes.append(f"device ms: kernel {device_ms(torch, lambda: kernel(*args, **kwargs)):.4f}"
                         f" library {dev_lib};")
        if extra.get("host"):
            notes.append(f"host {host_us(torch, lambda: kernel(*args, **kwargs)):.1f} us per call;")
        if "note" in extra:
            notes.append(extra["note"])
        print(f"{label} {name}: max|diff| {max(errs):.3e} {' '.join(notes)}  "
              f"kernel {ms:.4f} ms ({ms_b2b:.4f} ms each of {KERNEL_REPS} back to back)  "
              f"plain {plain_ms:.4f} ms  library {lib}  "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        # a functools.partial's counts are its function's
        results.append({"name": name, "wrapper": getattr(kernel, "func", kernel),
                        "source": extra.get("source"),
                        "replaces": replaces,
                        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})
    return results


def phase_serving(torch, np, fs, fa):
    from qat_vit_tpu_torch.data.pipeline import preprocess_fn
    from qat_vit_tpu_torch.models.registry import create_student
    from qat_vit_tpu_torch.serve.calibrate import ptq_convert
    from qat_vit_tpu_torch.serve.int8_vit import int8_apply
    from qat_vit_tpu_torch.serve.predictor import Int8Predictor

    dev = torch.device("cuda")
    bundle = create_student("vit", generator=torch.Generator().manual_seed(SEED), device=dev)
    cfg = bundle.cfg
    if (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.image_size, cfg.num_classes) != (384, 12, 6, 224, 10):
        fail(f"unexpected student geometry {cfg}")
    rng = np.random.default_rng(SEED + 1)
    prep = preprocess_fn(cfg.image_size, device=dev)
    calib = [prep(torch.from_numpy(rng.integers(0, 256, (CALIB_B, 32, 32, 3), dtype=np.uint8)))
             for _ in range(CALIB_BATCHES)]
    t0 = time.perf_counter()
    export = ptq_convert(bundle.module.state_dict(), calib, cfg, device=dev)
    torch.cuda.synchronize()
    print(f"phase 3 ptq_convert over {CALIB_BATCHES}x{CALIB_B} images: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    images = np.random.default_rng(SEED + 2).integers(0, 256, (N_IMAGES, 32, 32, 3), dtype=np.uint8)
    pred = Int8Predictor(export, cfg, batch_size=SERVE_B, device=dev)
    if pred.options.get("fused") != "megamodel":
        fail(f"serving preset on CUDA is {pred.options}, expected the megamodel chain")
    wrappers = {"int8_gemm": (fs.int8_dense, fs.int8_dense_gelu_q, fs.int8_dense_resid_ln_q),
                "ln_quantize": (fs.ln_quantize,), "attention_q": (fa.fused_attention_qkv,)}
    for group in wrappers.values():
        for w in group:
            w.launches = 0
    logits = pred.logits(images)
    torch.cuda.synchronize()
    launches = {w: w.launches for group in wrappers.values() for w in group}
    for kernel, group in wrappers.items():
        total = sum(launches[w] for w in group)
        print(f"phase 3 launches {kernel}: {total} "
              f"({', '.join(f'{w.__name__} {launches[w]}' for w in group)})", flush=True)
        if total == 0 or any(launches[w] == 0 for w in group):
            fail(f"the serving path did not launch every {kernel} kernel: {launches}")
    batches = N_IMAGES // SERVE_B  # per forward: K2a for qkv, patch and head; K2b for fc1
    if (launches[fs.int8_dense], launches[fs.int8_dense_gelu_q]) != (
            batches * (cfg.depth + 2), batches * cfg.depth):
        fail(f"int8_dense / int8_dense_gelu_q launches {launches[fs.int8_dense]} / "
             f"{launches[fs.int8_dense_gelu_q]} over {batches} forwards")
    if logits.shape != (N_IMAGES, cfg.num_classes) or not np.isfinite(logits).all():
        fail(f"logits {logits.shape}, finite {np.isfinite(logits).all()}")

    ref_chain, ref_hybrid, ref_exact, k3_calls = [], [], [], []
    for start in range(0, N_IMAGES, SERVE_B):
        x = prep(torch.from_numpy(images[start:start + SERVE_B]))
        ref_chain.append(int8_apply(pred.qparams, x, cfg, fused="megamodel_plain",
                                    compute_dtype=torch.bfloat16).cpu().numpy())
        with k3_in_plain_chain(fa) as calls:
            ref_hybrid.append(int8_apply(pred.qparams, x, cfg, fused="megamodel_plain",
                                         compute_dtype=torch.bfloat16).cpu().numpy())
        k3_calls += calls
        ref_exact.append(int8_apply(pred.qparams, x, cfg, fused="none").cpu().numpy())
    ref_chain, ref_hybrid, ref_exact = (np.concatenate(r) for r in (ref_chain, ref_hybrid,
                                                                    ref_exact))
    same = np.array_equal(logits, ref_hybrid)
    rel_chain = float(np.linalg.norm(logits - ref_chain) / np.linalg.norm(ref_chain))
    rel_exact = float(np.linalg.norm(logits - ref_exact) / np.linalg.norm(ref_exact))
    top1_chain = float((logits.argmax(-1) == ref_chain.argmax(-1)).mean())
    top1_exact = float((logits.argmax(-1) == ref_exact.argmax(-1)).mean())
    print(f"phase 3 logits vs the plain megamodel chain with K3's attention: identical {same} "
          f"(K3 per block within the int8 bound, exact shares "
          + ", ".join(f"{e:.7f}" for _, e in k3_calls) + ")", flush=True)
    print(f"phase 3 logits vs the plain megamodel chain: rel L2 {rel_chain:.3e} ("
          f"bound {CHAIN_REL_L2}), top-1 agreement {top1_chain:.4f}", flush=True)
    print(f"phase 3 logits vs exact f32 path: rel L2 {rel_exact:.3e} (bound {EXACT_REL_L2}), "
          f"top-1 agreement {top1_exact:.4f}", flush=True)
    if not same or len(k3_calls) != cfg.depth * (N_IMAGES // SERVE_B):
        fail(f"the kernel chain vs the plain chain with K3's attention: identical {same}, "
             f"{len(k3_calls)} attention calls")
    if rel_chain > CHAIN_REL_L2:
        fail(f"kernel chain vs plain chain rel L2 {rel_chain:.3e} > {CHAIN_REL_L2}")
    if rel_exact > EXACT_REL_L2:
        fail(f"kernel chain vs exact path rel L2 {rel_exact:.3e} > {EXACT_REL_L2}")

    # serving rate: pipelined stream of batch-256 uint8 batches, host clock
    # around work that ends in a synchronize (record, not a gate)
    batches = [images[:SERVE_B], images[SERVE_B:]] * 4
    for _ in pred.serve_stream(batches[:2]):
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(len(out) for out in pred.serve_stream(batches))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    bound_ms, bound_by = roofline(*chain_works(SERVE_B, cfg.seq_len, cfg.embed_dim, cfg.mlp_dim,
                                               cfg.num_heads, cfg.head_dim, cfg.depth,
                                               3 * cfg.patch_size ** 2, cfg.num_classes))
    print(f"phase 3 serving: {n / dt:.1f} img/s at batch {SERVE_B} "
          f"({n} images in {dt * 1e3:.1f} ms, {dt * 1e3 * SERVE_B / n:.2f} ms per batch; the "
          f"K4 chain's bound {bound_ms:.4f} ms ({bound_by})) on {card_line()}", flush=True)
    groups, busy, wall, n_kernels, counts = device_breakdown(
        torch, lambda: pred.logits(images[:SERVE_B]))
    if groups:
        print(f"phase 3 one profiled batch-{SERVE_B} forward (uint8 images in, logits out): "
              f"device busy {busy:.2f} of {wall:.2f} ms (idle {100 * (1 - busy / wall):.1f}%), "
              f"{n_kernels} kernels ({counts['K3 / kernel A']} K3, {counts['K2a PLAIN']} K2a, "
              f"{counts['K2b GELU_Q']} K2b, {counts[K7_GROUP]} K7); "
              "device ms "
              "by group: " + ", ".join(f"{g} {t:.2f}" for g, t in groups.most_common()),
              flush=True)
        if (counts["K3 / kernel A"], counts["K2a PLAIN"], counts["K2b GELU_Q"],
                counts[K7_GROUP]) != (cfg.depth, cfg.depth + 2, cfg.depth, 0):
            fail(f"the profiled forward ran {counts['K3 / kernel A']} K3, {counts['K2a PLAIN']} "
                 f"K2a, {counts['K2b GELU_Q']} K2b and {counts[K7_GROUP]} K7 kernels, "
                 f"expected {cfg.depth}, {cfg.depth + 2}, {cfg.depth} and 0")
    else:
        print("phase 3 one profiled forward: torch.profiler saw no device activity (breakdown "
              "not measured)", flush=True)
    return launches, {"qp": pred.qparams, "cfg": cfg, "images": images, "prep": prep,
                      "logits": logits, "export": export}


def vit_models(torch, seed=SEED):
    """A random-init ViT-S/16 student and bf16 ViT-B/16 teacher from ``seed``."""
    from qat_vit_tpu_torch.models.registry import create_student, create_teacher

    gen = torch.Generator().manual_seed(seed)
    teacher = create_teacher("vit", dtype=torch.bfloat16, generator=gen)
    student = create_student("vit", generator=gen)
    scfg, tcfg = student.cfg, teacher.cfg
    if ((scfg.embed_dim, scfg.depth, scfg.num_heads, scfg.mlp_dim, scfg.seq_len)
            != (384, 12, 6, 1536, 197) or (tcfg.embed_dim, tcfg.depth, tcfg.num_heads) != (768, 12, 12)):
        fail(f"unexpected geometry: student {scfg}, teacher {tcfg}")
    return student, teacher


def vit_trainer(torch, data, student, teacher, batch, seed=SEED, **hparams):
    """``KDQATTrainer`` on the card at its defaults (bf16, fast_math,
    fq_in_kernel, teacher logits cached), ``hparams`` over them."""
    from qat_vit_tpu_torch.train.config import load_hparams
    from qat_vit_tpu_torch.train.trainer import KDQATTrainer

    hp = load_hparams(None)
    hp.update(batch_size=batch, eval_batch_size=256, epochs=2, seed=seed, **hparams)
    t = KDQATTrainer(hp, device=torch.device("cuda"), data=data, student=student,
                     teacher=teacher)
    qc = t.student_qat_cfg
    if not (t.student_float_cfg.fast_math and qc.fast_math and qc.fq_in_kernel
            and qc.dtype == torch.bfloat16 and t.cache_teacher):
        fail(f"the trainer's defaults changed: {t.student_float_cfg} / {qc}")
    return t


def phase_training(torch, np, fs, fa, fat):
    """KD + QAT training of ViT-S/16 through the attention kernels."""
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.ops._cuda import reference_impl
    from qat_vit_tpu_torch.serve.predictor import Int8Predictor

    dev = torch.device("cuda")
    data = synthetic_cifar10(n_train=N_TRAIN, n_test=N_TEST, seed=SEED)
    student, teacher = vit_models(torch)
    scfg = student.cfg

    def trainer(batch):
        return vit_trainer(torch, data, student, teacher, batch)

    def run(t, counts=None, profiles=None):
        """3 float steps, the QAT switch, 3 QAT steps; the kernels' launches per
        phase and the device breakdown of one more step, taken after them."""
        out = []
        for epoch in (0, 1):
            if epoch:
                t.enable_qat()
            fa.attention_fwd.launches = fat.attention_bwd.launches = 0
            m = t.train_epoch(epoch, limit_batches=TRAIN_STEPS)
            torch.cuda.synchronize()
            if counts is not None:
                counts.append((fa.attention_fwd.launches, fat.attention_bwd.launches))
            if m["n_batches"] != TRAIN_STEPS or not np.isfinite(m["train_loss"]):
                fail(f"training epoch {epoch}: {m}")
            out.append(m)
            if profiles is not None:
                profiles.append(device_breakdown(
                    torch, lambda: t.train_epoch(epoch, limit_batches=1)))
        return out

    # each step from the same state through the kernels, through kernel A
    # with kernel B's plain version (the hybrid) and through the plain
    # versions, held to the limits VIT_REPLAY_*
    t = trainer(REPLAY_B)
    records = replay(torch, t, TRAIN_STEPS, [("kernels", contextlib.nullcontext)],
                     reference_impl, lambda: plain_kernel_b(fat))
    del t
    bad = []
    for phase, rec in enumerate(records):
        name = ("float", "QAT")[phase]
        limits = {"loss": (REPLAY_LOSS_REL, None)[phase], "params": REPLAY_PARAM_REL_L2,
                  "qkv_grad_plain": (VIT_REPLAY_QKV_GRAD_REL, None)[phase],
                  "qkv_grad": VIT_REPLAY_QKV_GRAD_HYBRID_REL[phase], "grad": None,
                  "update": None}
        for i, r in enumerate(rec):
            r = r["kernels"]
            print(f"phase 4 replay at batch {REPLAY_B}, {name} step {i + 1} from the same "
                  f"state: loss, params and qkv_grad_plain vs the plain step, grad, qkv_grad "
                  f"and update vs kernel A + plain kernel B: " + ", ".join(
                      f"{k} {r[k]:.3e} (limit {v})" for k, v in limits.items()), flush=True)
            bad += [f"{name} step {i + 1} {k} {r[k]:.3e} > {v}" for k, v in limits.items()
                    if v is not None and r[k] > v]
    if bad:
        fail(f"ViT-S: kernel vs plain steps from the same state: {'; '.join(bad)}")

    # the main path: batch 256
    t = trainer(TRAIN_B)
    t0 = time.perf_counter()
    t._ensure_teacher_logits()
    torch.cuda.synchronize()
    print(f"phase 4 teacher logits cached for {N_TRAIN} images: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    counts, profiles = [], []
    ms = run(t, counts, profiles)
    card = card_line()
    depth = scfg.depth
    for name, m, (nf, nb), (groups, busy, wall, n_kernels, by_group) in zip(
            ("float (bf16, fast_math)", "QAT (bf16, fq_in_kernel)"), ms, counts, profiles):
        print(f"phase 4 {name}: {TRAIN_STEPS} steps at batch {TRAIN_B}, mean loss "
              f"{m['train_loss']:.5f}, {m['imgs_per_sec']:.1f} img/s "
              f"({m['epoch_seconds'] * 1e3:.1f} ms, first step included) on {card}; "
              f"launches attention_fwd {nf} attention_bwd {nb}", flush=True)
        if nf != depth * TRAIN_STEPS or nb != depth * TRAIN_STEPS:
            fail(f"the {name} steps launched kernel A {nf} and kernel B {nb} times, expected "
                 f"{depth} each per step")
        if groups:
            kb = (by_group["kernel B rows"], by_group["kernel B keys"])
            print(f"phase 4 {name}, one more step under torch.profiler: host {wall:.1f} ms, "
                  f"device busy {busy:.1f} ms (idle {100 * (1 - busy / wall):.1f}%), "
                  f"{n_kernels} kernels ({by_group['K3 / kernel A']} kernel A, kernel B "
                  f"{kb[0]} rows and {kb[1]} keys passes); " + ", ".join(
                      f"{g} {v:.1f} ms" for g, v in groups.most_common()) + f" on {card}",
                  flush=True)
            if by_group["K3 / kernel A"] != depth or kb != (depth, depth):
                fail(f"the profiled {name} step ran {by_group['K3 / kernel A']} kernel A and "
                     f"{kb} kernel B (rows, keys) kernels, expected {depth} of each")
        else:
            print(f"phase 4 {name}: torch.profiler saw no device activity (breakdown not "
                  f"measured)", flush=True)
    acc = t.evaluate(limit_batches=1)
    export = t.convert_int8()
    serve = (fs.int8_dense, fs.int8_dense_gelu_q, fs.int8_dense_resid_ln_q, fs.ln_quantize,
             fa.fused_attention_qkv)
    for w in serve:
        w.launches = 0
    acc8 = t.evaluate_int8(export, limit_batches=1)
    torch.cuda.synchronize()
    if any(w.launches == 0 for w in serve):
        fail(f"int8 eval did not launch every serving kernel: {[w.launches for w in serve]}")
    logits = Int8Predictor(export, t.student_qat_cfg, batch_size=TRAIN_B,
                           device=dev).logits(data["test_images"][:TRAIN_B])
    if logits.shape != (TRAIN_B, 10) or not np.isfinite(logits).all():
        fail(f"int8 logits after training: {logits.shape}, finite {np.isfinite(logits).all()}")
    print(f"phase 4 QAT eval top-1 {acc:.4f}, int8 eval top-1 {acc8:.4f} (random-init "
          f"teacher: a record, not a gate); int8 logits finite", flush=True)
    # what phase 9 writes to files and reads back: the float student's
    # parameters after its steps, the teacher's, and the teacher's logits
    images = data["test_images"][:CKPT_TEACHER_IMAGES]
    def host_copy(module):
        return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}

    ckpt = {"data": data, "images": images, "teacher_logits": t._teacher_forward(images),
            "student": host_copy(t.student_float), "teacher": host_copy(t.teacher.module),
            "teacher_cfg": t.teacher.cfg}
    return {fa.attention_fwd: sum(c[0] for c in counts),
            fat.attention_bwd: sum(c[1] for c in counts)}, ckpt


def det_inputs(torch, np, seed, b, dev):
    """Seeded preprocessed 768 px images and 4 query embeddings per image."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (b, 768, 768, 3)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.normal(0, 1, (b, DET_Q, 512)).astype(np.float32)).to(dev)
    return x, q


def phase_detection(torch, np, fs, la):
    """int8 OWLv2-pruned detection serving through the long-sequence chain."""
    from qat_vit_tpu_torch.models.registry import create_model
    from qat_vit_tpu_torch.serve.calibrate import calibrate_detector
    from qat_vit_tpu_torch.serve.int8_detect import (
        convert_detector,
        int8_detect_apply,
        make_int8_detect_forward,
    )
    from qat_vit_tpu_torch.serve.int8_vit import export_to_device

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    bundle = create_model("owlv2_pruned_detector", qat_wrapper=True,
                          generator=torch.Generator().manual_seed(SEED), device=dev)
    cfg = bundle.cfg
    if ((cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.mlp_dim, cfg.seq_len, cfg.act, cfg.pre_norm,
         cfg.patch_bias, cfg.num_classes) != (576, 9, 9, 3072, 2305, "quick_gelu", True, False, 0)):
        fail(f"unexpected OWLv2-pruned geometry {cfg}")
    params = {k: v for k, v in bundle.module.state_dict().items()
              if not k.endswith(("min_val", "max_val"))}
    calib = [det_inputs(torch, np, SEED + 10 + i, 1, dev)[0] for i in range(DET_CALIB)]
    stats = calibrate_detector(params, calib, cfg, device=dev)
    export = export_to_device(convert_detector(params, stats, cfg), dev)
    torch.cuda.synchronize()
    print(f"phase 5 OWLv2-pruned detector built, calibrated on {DET_CALIB} images and "
          f"converted: {time.perf_counter() - t0:.2f} s", flush=True)

    # the kernels against their plain versions at the shapes this path gives them
    rng = np.random.default_rng(SEED + 5)
    d, mlp, heads, hd, n = 576, 3072, 9, 64, 2305
    b = DET_REF_B
    bf16 = torch.bfloat16
    in_q = {"scale": torch.tensor(0.02), "zero_point": torch.tensor(121.0)}
    out_q = {"scale": torch.tensor(8.0 / 255), "zero_point": torch.tensor(128.0)}
    gelu_q = {"scale": torch.tensor(4.0 / 255), "zero_point": torch.tensor(11.0)}
    qkv = torch.from_numpy(rng.normal(0, 1.0, (b, n, 3 * d)).astype(np.float32)).to(dev).to(bf16)
    x_bf16 = torch.from_numpy(rng.normal(0, 1.5, (b, n, d)).astype(np.float32)).to(dev).to(bf16)
    x_f32 = torch.from_numpy(rng.normal(0, 1.5, (b, n, d)).astype(np.float32)).to(dev)

    def act_int8(*shape):
        return rand_int8(torch, np, rng, dev, *shape)

    def layer(k, n_out, bias=True):
        return rand_layer(torch, np, rng, dev, k, n_out, bias=bias)

    m = b * n
    x_qkv, l_qkv = act_int8(b, n, d), layer(d, 3 * d)
    x_patch, l_patch = act_int8(b, n - 1, 768), layer(768, d, bias=False)
    x_proj, l_proj = act_int8(b, n, d), layer(d, d)
    x_fc1, l_fc1 = act_int8(b, n, d), layer(d, mlp)
    x_fc2, l_fc2 = act_int8(b, n, mlp), layer(mlp, d)
    cases = [
        (f"attention_long [{b}x{n}x{3 * d}] {heads} heads", la.long_attention_qkv,
         la.long_attention_qkv_plain, (qkv, heads, hd), {},
         "qat_vit_tpu/ops/long_attention.py:63", attention_work(b, n, heads, hd),
         sdpa_forward(torch, qkv, heads, hd), k5_tc(la, qkv, heads, hd)),
        (f"attention_long_q [{b}x{n}x{3 * d}] {heads} heads", la.long_attention_q,
         la.long_attention_qkv_plain, (qkv, heads, hd), {"out_q": out_q},
         "qat_vit_tpu/ops/long_block_kernel.py:262", attention_work(b, n, heads, hd, 1),
         sdpa_forward(torch, qkv, heads, hd)),
        (f"int8_gemm:plain qkv [{m}x{d}]@[{d}x{3 * d}]", fs.int8_dense, fs.int8_dense_plain,
         (x_qkv, l_qkv, in_q), {"out_dtype": bf16}, "qat_vit_tpu/ops/fused_serve.py:57",
         gemm_work(m, d, 3 * d, 2), int_mm(torch, x_qkv, l_qkv)),
        (f"int8_gemm:plain patch_embed no bias [{m - b}x768]@[768x{d}]", fs.int8_dense,
         fs.int8_dense_plain, (x_patch, l_patch, in_q), {"out_dtype": bf16},
         "qat_vit_tpu/ops/fused_serve.py:57", gemm_work(m - b, 768, d, 2, -4 * d),
         int_mm(torch, x_patch, l_patch)),
        (f"int8_gemm:resid_ln_q proj [{m}x{d}]@[{d}x{d}]", fs.int8_dense_resid_ln_q,
         fs.int8_dense_resid_ln_q_plain,
         (x_proj, l_proj, in_q, x_bf16, rand_ln(torch, np, rng, dev, d),
          out_q),
         {"out_dtype": torch.float32, "eps": 1e-5}, "qat_vit_tpu/ops/fused_serve.py:87",
         gemm_work(m, d, d, 4 + 1, 2 * m * d + 8 * d), int_mm(torch, x_proj, l_proj)),
        (f"int8_gemm:gelu_q quick-GELU fc1 [{m}x{d}]@[{d}x{mlp}]", fs.int8_dense_gelu_q,
         fs.int8_dense_gelu_q_plain, (x_fc1, l_fc1, in_q, gelu_q), {"act": "quick_gelu"},
         "qat_vit_tpu/ops/fused_serve.py:70", gemm_work(m, d, mlp, 1),
         int_mm(torch, x_fc1, l_fc1)),
        (f"int8_gemm:resid_ln_q fc2 [{m}x{mlp}]@[{mlp}x{d}]", fs.int8_dense_resid_ln_q,
         fs.int8_dense_resid_ln_q_plain,
         (x_fc2, l_fc2, in_q, x_f32, rand_ln(torch, np, rng, dev, d),
          out_q),
         {"out_dtype": bf16, "eps": 1e-5}, "qat_vit_tpu/ops/fused_serve.py:87",
         gemm_work(m, mlp, d, 2 + 1, 4 * m * d + 8 * d), int_mm(torch, x_fc2, l_fc2)),
        (f"ln_quantize [{m}x{d}] bf16", fs.ln_quantize, fs.ln_quantize_plain,
         (x_bf16, rand_ln(torch, np, rng, dev, d), out_q), {"eps": 1e-5},
         "qat_vit_tpu/ops/fused_serve.py:105", ln_work(m, d, 2), None),
    ]
    kernels = check_kernels(torch, cases, "phase 5", slow_plain=(la.long_attention_qkv_plain,))
    del qkv, x_bf16, x_f32, cases

    # the main path: the preset (megamodel_long) at batch 8 with 4 queries
    fwd = make_int8_detect_forward(cfg, dev)
    if fwd.options.get("fused") != "megamodel_long":
        fail(f"detection preset on CUDA is {fwd.options}, expected the megamodel_long chain")
    x, q = det_inputs(torch, np, SEED + 20, DET_B, dev)
    wrappers = (fs.int8_dense, fs.int8_dense_resid_ln_q, fs.int8_dense_gelu_q, fs.ln_quantize,
                la.long_attention_q, la.long_attention_qkv)
    for w in wrappers:
        w.launches = 0
    out = fwd(export, x, q)
    torch.cuda.synchronize()
    launches = {w: w.launches for w in wrappers}
    depth = cfg.depth
    want = {fs.int8_dense: 1 + depth, fs.int8_dense_resid_ln_q: 2 * depth,
            fs.int8_dense_gelu_q: depth, fs.ln_quantize: 1, la.long_attention_q: depth,
            la.long_attention_qkv: 0}
    print(f"phase 5 launches per batch-{DET_B} forward: {sum(launches.values())} = "
          f"{depth} blocks x 5 + patch GEMM + entry LN ("
          f"{', '.join(f'{w.__name__} {launches[w]}' for w in wrappers)})", flush=True)
    if launches != want:
        fail(f"the detection path's launches {launches}, expected {want}")
    p = cfg.num_patches
    shapes = {"pred_boxes": (DET_B, p, 4), "logits": (DET_B, p, DET_Q),
              "objectness_logits": (DET_B, p), "class_embeds": (DET_B, p, 512),
              "image_embeds": (DET_B, p, cfg.embed_dim)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
            fail(f"{k}: {tuple(out[k].shape)} (expected {shape}), finite "
                 f"{bool(torch.isfinite(out[k]).all())}")

    # the same chain through the plain versions, at batch DET_REF_B
    plain = int8_detect_apply(export, x[:DET_REF_B], cfg, q[:DET_REF_B],
                              **{**fwd.options, "fused": "megamodel_long_plain"})
    rels = {k: rel_l2(out[k][:DET_REF_B].float(), plain[k].float()) for k in shapes}
    print(f"phase 5 vs the plain chain at batch {DET_REF_B}: rel L2 " + ", ".join(
        f"{k} {v:.3e}" for k, v in rels.items()) + f" (logits held within {LONG_CHAIN_REL_L2}, "
          "the rest printed)", flush=True)
    if rels["logits"] > LONG_CHAIN_REL_L2:
        fail(f"detection: logits vs the plain chain rel L2 {rels['logits']:.3e} > "
             f"{LONG_CHAIN_REL_L2}")
    # the plain chain with K6a as its attention stage: identical
    with kernel_attention_in_plain_chain(la) as calls:
        hybrid = int8_detect_apply(export, x[:DET_REF_B], cfg, q[:DET_REF_B],
                                   **{**fwd.options, "fused": "megamodel_long_plain"})
    same = all(torch.equal(out[k][:DET_REF_B], hybrid[k]) for k in shapes)
    print(f"phase 5 the plain chain with K6a's attention at batch {DET_REF_B}: identical to the "
          f"kernel chain {same}; K6a per block within the int8 bound, exact shares "
          + ", ".join(f"{e:.7f}" for _, e in calls), flush=True)
    if not same or len(calls) != depth:
        fail(f"detection: the plain chain with K6a's attention identical {same}, "
             f"{len(calls)} attention calls (expected {depth})")
    del hybrid
    # the chain and its plain version timed at batch DET_REF_B (K6b's row)
    ms_k = median_ms(lambda: fwd(export, x[:DET_REF_B], q[:DET_REF_B]), runs=DET_TIMING_RUNS)
    ms_p = median_ms(lambda: int8_detect_apply(export, x[:DET_REF_B], cfg, q[:DET_REF_B], **{
        **fwd.options, "fused": "megamodel_long_plain"}), runs=3, warmup=1)
    print(f"phase 5 the megamodel_long chain at batch {DET_REF_B}: {ms_k:.2f} ms per forward, "
          f"through the plain versions {ms_p:.2f} ms (medians of {DET_TIMING_RUNS} and 3)",
          flush=True)
    # against the exact f32 path (f32 stream and attention, divide-quantize)
    exact = int8_detect_apply(export, x, cfg, q)
    box_err = float((out["pred_boxes"] - exact["pred_boxes"]).abs().mean())
    corr = {k: float(np.corrcoef(out[k].flatten().cpu().numpy(),
                                 exact[k].flatten().cpu().numpy())[0, 1])
            for k in ("logits", "objectness_logits")}
    print(f"phase 5 vs the exact f32 path: pred_boxes mean |err| {box_err:.3e} (bound "
          f"{DET_BOX_MEAN_ERR}), corr logits {corr['logits']:.5f} objectness "
          f"{corr['objectness_logits']:.5f} (bound > {DET_CORR})", flush=True)
    if box_err > DET_BOX_MEAN_ERR or min(corr.values()) <= DET_CORR:
        fail(f"detection vs the exact path: box err {box_err:.3e}, corr {corr}")

    ms = median_ms(lambda: fwd(export, x, q), runs=DET_TIMING_RUNS)
    bound_ms, bound_by = roofline(*chain_works(DET_B, cfg.seq_len, cfg.embed_dim, cfg.mlp_dim,
                                               cfg.num_heads, cfg.head_dim, depth,
                                               3 * cfg.patch_size ** 2))
    print(f"phase 5 int8 detection: {ms:.2f} ms per batch-{DET_B} forward with {DET_Q} queries "
          f"(median of {DET_TIMING_RUNS}, warm-up excluded; the K6 chain's bound "
          f"{bound_ms:.4f} ms ({bound_by})) on {card_line()}", flush=True)
    groups, busy, wall, n_kernels, _ = device_breakdown(torch, lambda: fwd(export, x, q))
    print(f"phase 5 one profiled batch-{DET_B} forward: device busy {busy:.2f} of {wall:.2f} ms "
          f"(idle {100 * (1 - busy / wall):.1f}%), {n_kernels} kernels; device ms by group: "
          + ", ".join(f"{g} {t:.2f}" for g, t in groups.most_common()), flush=True)
    del out, plain

    # the exact path with its attention on the long attention kernel (K5a)
    k5a = make_int8_detect_forward(cfg, dev, preset=False, attn_impl="pallas_long",
                                   attn_dtype=torch.bfloat16)
    for w in wrappers:
        w.launches = 0
    out = k5a(export, x[:DET_REF_B], q[:DET_REF_B])
    torch.cuda.synchronize()
    k5a_launches = {w: w.launches for w in wrappers}
    box_err = float((out["pred_boxes"] - exact["pred_boxes"][:DET_REF_B]).abs().mean())
    print(f"phase 5 exact path with attn_impl=pallas_long at batch {DET_REF_B}: "
          f"attention_long launches {k5a_launches[la.long_attention_qkv]}, pred_boxes mean "
          f"|err| vs the f32 attention {box_err:.3e}", flush=True)
    if k5a_launches[la.long_attention_qkv] != depth or box_err > DET_BOX_MEAN_ERR:
        fail(f"the pallas_long path: launches {k5a_launches}, box err {box_err:.3e}")
    for k in kernels:
        path = k5a_launches if k["wrapper"] is la.long_attention_qkv else launches
        k["launches"] = path[k["wrapper"]]
    return kernels, {"export": export, "cfg": cfg, "x": x, "q": q, "exact": exact}


@contextlib.contextmanager
def swapped(module, **attrs):
    """``module``'s functions ``attrs`` replaced for the block."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def plain_k5b(la):
    """The training pair on K5a's forward with K5b's plain version (a scoped
    stand-in for ``long_attention_bwd`` that takes only the training path's
    call): the backward's reference on the kernels' own forward."""
    def bwd(qkv, do, heads, hd, *, out=None, lse=None):
        return la.long_attention_bwd_plain(qkv, do, heads, hd)
    return swapped(la, long_attention_bwd=bwd)


def plain_kernel_b(fat):
    """The training attention on kernel A's forward with kernel B's plain
    version (a scoped stand-in for ``attention_bwd``)."""
    def bwd(qkv, do, heads, hd, *, qs=None, in_fq=None, n_valid=None):
        return fat.attention_bwd_plain(qkv, do, heads, hd, qs=qs, in_fq=in_fq, n_valid=n_valid)
    return swapped(fat, attention_bwd=bwd)


def same_state_step(torch, step, records, variants, plain, hybrid):
    """``step`` (a train step ``(state, batch, loss_hp) -> metrics``) run
    from the same state under each of ``variants`` ((name, context manager
    factory) pairs), under ``hybrid`` (the forward kernel with the
    backward's plain version) and last under ``plain`` (the plain versions),
    whose result the run keeps. ``records`` gets one dict per call, for each
    variant: against the plain step, the loss's rel difference (``loss``),
    the parameters' rel L2 after the step (``params``) and the rel L2 of the
    gradient on the qkv weights (``qkv_grad_plain``); against the hybrid
    step (the same forward, so that they see the backward alone) the rel L2
    of the gradient the optimizer took (``grad``), of its part on the qkv
    weights, the first that the attention backward's output reaches
    (``qkv_grad``), and of the update (``update``: ‖θ − θ_ref‖ /
    ‖Δθ_ref‖); and whether gradient and parameters equal the hybrid's bit
    for bit (``hybrid_same``)."""
    import copy

    def flat(tensors):
        return torch.cat([t.detach().float().flatten() for t in tensors])

    def call(state, batch, loss_hp):
        params = state.optimizer.params
        qkv_w = [p for n, p in state.module.named_parameters() if n.endswith("attn.qkv.weight")]
        snap = (copy.deepcopy(state.module.state_dict()),
                copy.deepcopy(state.optimizer.adamw.state_dict()), state.step)
        before = flat(params)

        def run(ctx):
            # AdamW takes the moments' tensors as they are: a copy each time
            state.module.load_state_dict(snap[0])
            state.optimizer.adamw.load_state_dict(copy.deepcopy(snap[1]))
            state.step = snap[2]
            with ctx():
                m = step(state, batch, loss_hp)
            grads = flat(torch.zeros_like(p) if p.grad is None else p.grad for p in params)
            return m, float(m["train_loss"]), grads, flat(p.grad for p in qkv_w), flat(params)

        got = {name: run(ctx)[1:] for name, ctx in variants}
        _, _, gh, qh, ph = run(hybrid)
        mp, lp, _, qp, pp = run(plain)
        moved = float((ph - before).norm())
        records.append({name: {"loss": abs(lv - lp) / abs(lp), "params": rel_l2(pv, pp),
                               "grad": rel_l2(gv, gh), "qkv_grad": rel_l2(qv, qh),
                               "qkv_grad_plain": rel_l2(qv, qp),
                               "update": float((pv - ph).norm()) / moved,
                               "hybrid_same": bool(torch.equal(gv, gh) and torch.equal(pv, ph))}
                        for name, (lv, gv, qv, pv) in got.items()})
        return mp
    return call


def replay(torch, t, steps, variants, plain, hybrid):
    """``steps`` float steps of the trainer ``t``, the QAT switch and
    ``steps`` QAT steps, each step compared from the same state
    (:func:`same_state_step`) → (float records, QAT records)."""
    import math

    records = ([], [])
    t.train_step_float, t.train_step_qat = (
        same_state_step(torch, step, rec, variants, plain, hybrid)
        for step, rec in zip((t.train_step_float, t.train_step_qat), records))
    for epoch in (0, 1):
        if epoch:
            t.enable_qat()
        m = t.train_epoch(epoch, limit_batches=steps)
        if m["n_batches"] != steps or not math.isfinite(m["train_loss"]):
            fail(f"replay epoch {epoch}: {m}")
        if len(records[epoch]) != steps:
            fail(f"replay: {len(records[epoch])} steps compared, expected {steps}")
    return records


def replay_detect(torch, la, t, steps, variants, reference_impl):
    """:func:`replay` of the detection trainer ``t``, its backward metrics
    against K5a with K5b's plain version."""
    return replay(torch, t, steps, variants, reference_impl, lambda: plain_k5b(la))


def detect_trainer(torch, data, batch, depth=None, seed=SEED):
    """``DetectKDTrainer`` on the card at its defaults (OWLv2-pruned student,
    OWLv2-base teacher, 768 px), ``depth`` cutting both towers."""
    from qat_vit_tpu_torch.train.config import load_hparams
    from qat_vit_tpu_torch.train.detect_trainer import DetectKDTrainer

    hp = load_hparams(None)
    hp.update(task="detection", image_size=768, batch_size=batch, eval_batch_size=DT_EVAL_B,
              epochs=2, seed=seed)
    if depth is not None:
        hp["depth"] = depth  # teacher and student
    t = DetectKDTrainer(hp, device=torch.device("cuda"), data=data)
    sc, qc, tc = t.student_float_cfg, t.student_qat_cfg, t.teacher.cfg
    if ((sc.embed_dim, sc.num_heads, sc.mlp_dim, sc.seq_len, sc.act, sc.pre_norm)
            != (576, 9, 3072, 2305, "quick_gelu", True)
            or (tc.embed_dim, tc.num_heads, tc.seq_len, tc.dtype, tc.fast_math)
            != (768, 12, 2305, torch.bfloat16, False)
            or sc.depth != (depth or 9) or tc.depth != (depth or 12)):
        fail(f"unexpected detection geometry: student {sc}, teacher {tc}")
    if not (sc.fast_math and qc.fast_math and sc.dtype == qc.dtype == torch.bfloat16
            and t.cache_teacher):
        fail(f"the detection trainer's defaults changed: {sc} / {qc}")
    return t


def phase_detect_training(torch, np, fs, la):
    """OWLv2 detection KD + QAT training through the long attention pair (K5a, K5b)."""
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.ops._cuda import reference_impl

    dev = torch.device("cuda")
    # K5a and K5b against their plain versions at the shapes the student's
    # main path gives them (batch 16)
    rng = np.random.default_rng(SEED + 6)
    b, n, heads, hd = DT_B, 2305, 9, 64
    qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * heads * hd)).astype(np.float32))
    qkv = qkv.to(dev).to(torch.bfloat16)
    do = torch.from_numpy(rng.normal(0, 1, (b, n, heads * hd)).astype(np.float32))
    do = do.to(dev).to(torch.bfloat16)
    # the backward as the training path calls it: with the forward's output
    # and log-sum-exp
    out, lse = la._attention_launch(qkv, heads, hd, None, want_lse=True)
    cases = [(f"attention_long [{b}x{n}x{3 * heads * hd}] {heads} heads", la.long_attention_qkv,
              la.long_attention_qkv_plain, (qkv, heads, hd), {},
              "qat_vit_tpu/ops/long_attention.py:63", attention_work(b, n, heads, hd),
              sdpa_forward(torch, qkv, heads, hd), k5_tc(la, qkv, heads, hd)),
             (f"attention_long_bwd [{b}x{n}x{3 * heads * hd}] {heads} heads",
              la.long_attention_bwd, la.long_attention_bwd_plain, (qkv, do, heads, hd),
              {"out": out, "lse": lse}, "qat_vit_tpu/ops/long_attention.py:173",
              attention_work(b, n, heads, hd, backward=True),
              sdpa_backward(torch, qkv, do, heads, hd), k5_tc(la, qkv, heads, hd, do))]
    kernels = check_kernels(torch, cases, "phase 6", slow_plain=(la.long_attention_qkv_plain,
                                                                 la.long_attention_bwd_plain))
    del qkv, do, out, lse, cases

    data = synthetic_cifar10(n_train=DT_N_TRAIN, n_test=DT_EVAL_B * DT_EVAL_BATCHES, seed=SEED)

    def run(t, steps, counts, times, profiles):
        """``steps`` float steps, the QAT switch, ``steps`` QAT steps; per
        phase the K5a/K5b launches, each step's host time ending in a
        synchronize and the device breakdown of one more step, taken after
        the phase's counts are read."""
        def timed(step, out):
            def call(state, batch, loss_hp):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = step(state, batch, loss_hp)
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
                return metrics
            return call
        times.extend(([], []))
        t.train_step_float = timed(t.train_step_float, times[0])
        t.train_step_qat = timed(t.train_step_qat, times[1])
        out = []
        for epoch in (0, 1):
            if epoch:
                t.enable_qat()
            la.long_attention_qkv.launches = la.long_attention_bwd.launches = 0
            m = t.train_epoch(epoch, limit_batches=steps)
            torch.cuda.synchronize()
            counts.append((la.long_attention_qkv.launches, la.long_attention_bwd.launches))
            if m["n_batches"] != steps or not np.isfinite(m["train_loss"]):
                fail(f"detection training epoch {epoch}: {m}")
            out.append(m)
            profiles.append(device_breakdown(torch, lambda: t.train_epoch(epoch, limit_batches=1)))
        return out

    # the same steps through the kernels and through their plain versions,
    # each from the same state, held to the fixed limits DT_REPLAY_*
    t = detect_trainer(torch, data, DT_REPLAY_B, DT_REPLAY_DEPTH)
    records = replay_detect(torch, la, t, DT_REPLAY_STEPS, [("kernels", contextlib.nullcontext)],
                            reference_impl)
    del t
    bad = []
    for phase, rec in enumerate(records):
        name = ("float", "QAT")[phase]
        limits = {"loss": (REPLAY_LOSS_REL, None)[phase], "params": REPLAY_PARAM_REL_L2,
                  "qkv_grad": DT_REPLAY_QKV_GRAD_REL, "grad": None, "update": None}
        for i, r in enumerate(rec):
            r = r["kernels"]
            print(f"phase 6 replay at batch {DT_REPLAY_B}, depth {DT_REPLAY_DEPTH}, {name} step "
                  f"{i + 1} from the same state: loss and params vs the plain step, grad, "
                  f"qkv_grad and update vs K5a + plain K5b: " + ", ".join(
                      f"{k} {r[k]:.3e} " + ("(printed only)" if v is None else f"(limit {v})")
                      for k, v in limits.items()), flush=True)
            bad += [f"{name} step {i + 1} {k} {r[k]:.3e} > {v}" for k, v in limits.items()
                    if v is not None and r[k] > v]
    if bad:
        fail(f"detection: kernel vs plain steps from the same state: {'; '.join(bad)}")

    # the main path: full depth, batch 16
    t = detect_trainer(torch, data, DT_B)
    t0 = time.perf_counter()
    t._ensure_teacher_outputs()
    torch.cuda.synchronize()
    card = card_line()
    print(f"phase 6 teacher outputs cached for {DT_N_TRAIN} images (OWLv2-base, 768 px, "
          f"{t.num_queries} queries, chunks of {DT_EVAL_B}): {time.perf_counter() - t0:.2f} s "
          f"on {card}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    counts, times, profiles = [], [], []
    ms = run(t, DT_STEPS, counts, times, profiles)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    depth = t.student_qat_cfg.depth
    for name, m, (nf, nb), ts, (groups, busy, wall, n_kernels, _) in zip(
            ("float (bf16, fast_math)", "QAT (bf16, qat_amp)"), ms, counts, times, profiles):
        steady = ts[1:DT_STEPS]  # the profiled step after them is not timed here
        step_ms = 1e3 * statistics.median(steady)
        print(f"phase 6 {name}: {DT_STEPS} steps at batch {DT_B}, mean loss "
              f"{m['train_loss']:.5f}; first step {1e3 * ts[0]:.1f} ms, then "
              f"{', '.join(f'{1e3 * s:.1f}' for s in steady)} ms (median {step_ms:.1f} ms, "
              f"{DT_B / statistics.mean(steady):.2f} img/s; epoch {m['imgs_per_sec']:.2f} img/s "
              f"first step included) on {card}; launches attention_long {nf} "
              f"attention_long_bwd {nb} ({nf / DT_STEPS:g} and {nb / DT_STEPS:g} per step; "
              f"K5b is two kernels per layer)", flush=True)
        if nf != depth * DT_STEPS or nb != 2 * depth * DT_STEPS:
            fail(f"the {name} steps launched K5a {nf} and K5b {nb} times, expected "
                 f"{depth} and {2 * depth} per step")
        if groups:
            print(f"phase 6 {name}, one more step under torch.profiler: host {wall:.1f} ms, "
                  f"device busy {busy:.1f} ms (idle {100 * (1 - busy / wall):.1f}%), "
                  f"{n_kernels} kernels; " + ", ".join(
                      f"{g} {v:.1f} ms" for g, v in groups.most_common()) + f" on {card}",
                  flush=True)
        else:
            print(f"phase 6 {name}: torch.profiler saw no device activity (breakdown not "
                  f"measured)", flush=True)
    print(f"phase 6 peak device memory over the 6 steps: {peak_gb:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)", flush=True)

    ev = t.evaluate(limit_batches=DT_EVAL_BATCHES)
    export = t.convert_int8()
    serve = (fs.int8_dense, fs.int8_dense_gelu_q, fs.int8_dense_resid_ln_q, fs.ln_quantize,
             la.long_attention_q)
    for w in serve:
        w.launches = 0
    i8 = t.evaluate_int8(export, limit_batches=DT_EVAL_BATCHES)
    torch.cuda.synchronize()
    if any(w.launches == 0 for w in serve):
        fail(f"int8 detection eval did not launch every serving kernel: "
             f"{[w.launches for w in serve]}")
    print(f"phase 6 QAT eval vs the teacher: box err {ev['box_err']:.5f}, top-box agreement "
          f"{ev['teacher_agreement']:.4f} (random-init teacher: a record); int8 vs the "
          f"fake-quant detector over {DT_EVAL_BATCHES}x{DT_EVAL_B} images: |Δbox| "
          f"{i8['int8_box_err']:.3e} (bound {DET_BOX_MEAN_ERR}), top-box agreement "
          f"{i8['int8_top_box_agreement']:.4f}", flush=True)
    if not (np.isfinite(ev["box_err"]) and i8["int8_box_err"] <= DET_BOX_MEAN_ERR):
        fail(f"detection eval after training: {ev}, int8 {i8}")
    launches = {la.long_attention_qkv: sum(c[0] for c in counts),
                la.long_attention_bwd: sum(c[1] for c in counts)}
    for k in kernels:
        k["launches"] = launches[k["wrapper"]]
    return kernels


def phase_serve_modes(torch, np, fs, fa, ctx):
    """The rest of int8 ViT-S/16 serving on phase 3's export: K7, K8 and the
    K9 kernels against their plain versions; the exact path on K7 + K8; the
    mixed chains; the megablock / megamodel_res modes at batch 256."""
    import ctypes

    from qat_vit_tpu_torch import _build
    from qat_vit_tpu_torch.ops import block_kernel as bk
    from qat_vit_tpu_torch.ops import long_attention as la
    from qat_vit_tpu_torch.ops import pallas_gemm as pg
    from qat_vit_tpu_torch.ops._cuda import reference_impl
    from qat_vit_tpu_torch.serve.int8_vit import _embed, int8_apply

    dev = torch.device("cuda")
    qp, cfg, images, prep = ctx["qp"], ctx["cfg"], ctx["images"], ctx["prep"]
    n_tok, d, mlp, heads, hd, depth = (cfg.seq_len, cfg.embed_dim, cfg.mlp_dim, cfg.num_heads,
                                       cfg.head_dim, cfg.depth)
    b = B_KERNEL
    bf16, f32t = torch.bfloat16, torch.float32
    rng = np.random.default_rng(SEED + 7)
    card = card_line()

    # (a) K7 at the exact path's shapes (batch 32), f32 / per-tensor and
    # bf16 / per-channel at each; (b) K8 at [32, 197, 1152]
    in_q = {"scale": torch.tensor(4.0 / 255), "zero_point": torch.tensor(100.0)}
    cases = []
    for name, m_rows, k, n in (("patch_embed", b * (n_tok - 1), 3 * cfg.patch_size ** 2, d),
                               ("qkv", b * n_tok, d, 3 * d), ("proj", b * n_tok, d, d),
                               ("fc1", b * n_tok, d, mlp), ("fc2", b * n_tok, mlp, d),
                               # K = 32 (mod 64), which JAX's gate admits, and a
                               # ragged M at a unit past N
                               ("K 96", 8, 96, 128), ("K 480", b * n_tok, 480, d),
                               ("K 96 ragged", 2 * n_tok, 96, 640)):
        for x_dt, per_channel in ((f32t, False), (bf16, True)):
            x = torch.from_numpy(rng.normal(0, 1.5, (m_rows, k)).astype(np.float32)).to(dev)
            x = x.to(x_dt)
            layer = rand_layer(torch, np, rng, dev, k, n, per_channel)
            kw = {"x_scale": in_q["scale"], "x_zero_point": in_q["zero_point"],
                  "w_scale": layer["w_scale"], "w_colsum": layer["w_colsum"],
                  "bias": layer["bias"], "out_dtype": f32t}
            x_q = fs.quantize_mul(x.float(), fs.inv_scale(in_q["scale"]), 100.0, 255.0)
            in_bytes = 4 if x_dt == f32t else 2
            cases.append((
                f"fused_quantize_matmul {name} [{m_rows}x{k}]@[{k}x{n}] "
                f"{'f32' if x_dt == f32t else 'bf16'} in, "
                f"{'per-channel' if per_channel else 'per-tensor'}",
                functools.partial(pg.fused_quantize_matmul, w_t=layer["w_int8_t"]),
                pg.fused_quantize_matmul_plain, (x, layer["w_int8"]),
                kw, "qat_vit_tpu/ops/pallas_gemm.py:51",
                gemm_work(m_rows, k, n, 4, (in_bytes - 1) * m_rows * k),
                int_mm(torch, x_q, layer), {"exact": True, "repeat": True}))
    # K8 at [32, 197, 1152] and, past the earlier kernel's plan, at ViT-S/16's
    # 577 tokens at 384 px: f32 identical, bf16 by compare_tc
    qkv = torch.from_numpy(rng.normal(0, 1.0, (b, n_tok, 3 * d)).astype(np.float32)).to(dev)
    qkv384 = torch.from_numpy(rng.normal(0, 1.0, (K8_B384, K8_N384, 3 * d)).astype(
        np.float32)).to(dev)
    for x, dt, n_valid in ((qkv, f32t, n_tok), (qkv, f32t, 3 * n_tok // 4),
                           (qkv, bf16, 3 * n_tok // 4), (qkv384, f32t, K8_N384),
                           (qkv384, bf16, K8_N384 - 7)):
        t = x.to(dt)
        xb, xn = t.shape[:2]
        eb = 4 if dt == f32t else 2
        if dt == f32t:
            extra = {"source": F32_ATTENTION, "exact": True, "repeat": True}
        else:
            extra = {"source": SHORT_MMA_ATTENTION,
                     "tc": (lambda t=t, nv=n_valid: la.long_attention_f64(t, heads, hd,
                                                                          n_valid=nv)[0], 1)}
        cases.append((
            f"flash_attention [{xb}x{xn}x{3 * d}] {heads} heads "
            f"{'f32' if dt == f32t else 'bf16'} n_valid {n_valid}",
            fa.flash_attention_qkv, fa.flash_attention_qkv_plain, (t, heads, hd),
            {"n_valid": n_valid}, "qat_vit_tpu/ops/flash_attention.py:36",
            attention_work(xb, xn, heads, hd, eb, in_bytes=eb,
                           op_type="f32" if dt == f32t else "bf16"),
            sdpa_forward(torch, t, heads, hd), extra))
    # K9a (block 0) and K9b (all 12 blocks) at batch 32 on this export's
    # own activations, against their twin: the chain through the plain ops
    # with K3 as its attention stage (K9 runs K3's tile)
    x32 = prep(torch.from_numpy(images[:b]))
    xe = _embed(qp, x32, cfg, bf16, fs.int8_dense)
    blk0 = qp["blocks"]["0"]
    zq = fs.ln_quantize(xe, blk0["norm1"], blk0["norm1"]["out_q"], eps=cfg.layer_norm_eps)
    kw9 = {"num_heads": heads, "head_dim": hd, "eps": cfg.layer_norm_eps, "n_valid": n_tok}
    one_block = block_works(b, n_tok, d, mlp, heads, hd)
    k9_twin = {"exact": True, "repeat": True}
    cases.append((f"megablock (K9a) one ViT-S block [{b}x{n_tok}x{d}]", bk.megablock_forward,
                  k9_with_k3(fa, bk, bk.megablock_forward_plain),
                  (zq, xe, blk0, qp["blocks"]["1"]["norm1"]), kw9,
                  "qat_vit_tpu/ops/block_kernel.py:202", one_block, None, k9_twin))
    k9b_twin = k9_with_k3(fa, bk, bk.megamodel_res_forward_plain)
    cases.append((f"megamodel_res (K9b) {depth} ViT-S blocks [{b}x{n_tok}x{d}]",
                  bk.megamodel_res_forward, k9b_twin,
                  (zq, xe, qp["blocks"], qp["norm"]), {**kw9, "depth": depth},
                  "qat_vit_tpu/ops/block_kernel.py:404", one_block * depth, None, k9_twin))
    kernels = check_kernels(torch, cases, "phase 7", slow_plain=(k9b_twin,))
    del qkv, qkv384, cases
    one = bk.megablock_forward(zq, xe, blk0, qp["blocks"]["1"]["norm1"], **kw9)
    whole = bk.megamodel_res_forward(zq, xe, qp["blocks"], qp["norm"], depth=depth, **kw9)
    same = (all(map(torch.equal, one, bk.block_forward(zq, xe, blk0, qp["blocks"]["1"]["norm1"],
                                                       **kw9))),
            all(map(torch.equal, whole, bk.model_forward(zq, xe, qp["blocks"], qp["norm"],
                                                         depth=depth, **kw9))))
    ms_chain = median_ms(lambda: bk.model_forward(zq, xe, qp["blocks"], qp["norm"], depth=depth,
                                                  **kw9))
    print(f"phase 7 K9a / K9b at batch {b}: x, zq identical to the megamodel kernel chain "
          f"{same[0]} / {same[1]}; the chain over the same {depth} blocks {ms_chain:.4f} ms "
          f"({5 * depth} launches)", flush=True)
    if not all(same):
        fail(f"K9a / K9b at batch {b}: identical to the kernel chain {same}")
    k9_at_480(torch, fa, bk, ctx)

    # (c) the exact path on K7 + K8 (f32 stream and attention) at batch 32
    launches = {}
    pg.fused_quantize_matmul.launches = fa.flash_attention_qkv.launches = 0
    exact_k = int8_apply(qp, x32, cfg, use_pallas=True, attn_impl="pallas")
    torch.cuda.synchronize()
    launches[pg.fused_quantize_matmul] = pg.fused_quantize_matmul.launches
    launches[fa.flash_attention_qkv] = fa.flash_attention_qkv.launches
    with reference_impl():
        exact_p = int8_apply(qp, x32, cfg, use_pallas=True, attn_impl="pallas")
    exact = int8_apply(qp, x32, cfg)
    torch.cuda.synchronize()
    rel = float((exact_k - exact).norm() / exact.norm())
    print(f"phase 7 exact path with use_pallas=True, attn_impl=pallas at batch {b}: launches "
          f"fused_quantize_matmul {launches[pg.fused_quantize_matmul]} flash_attention "
          f"{launches[fa.flash_attention_qkv]}; identical to the same path through the plain "
          f"K7/K8 {torch.equal(exact_k, exact_p)}; vs the exact path rel L2 {rel:.3e} (bound "
          f"{EXACT_REL_L2}), top-1 agreement "
          f"{float((exact_k.argmax(-1) == exact.argmax(-1)).float().mean()):.4f}", flush=True)
    if (launches[pg.fused_quantize_matmul] != 1 + 4 * depth
            or launches[fa.flash_attention_qkv] != depth):
        fail(f"the exact path on K7/K8 launched {launches}, expected {1 + 4 * depth} and {depth}")
    if not torch.equal(exact_k, exact_p) or rel > EXACT_REL_L2:
        fail(f"the exact path on K7/K8: identical to plain {torch.equal(exact_k, exact_p)}, "
             f"rel L2 vs exact {rel:.3e}")
    ms_k = median_ms(lambda: int8_apply(qp, x32, cfg, use_pallas=True, attn_impl="pallas"),
                     runs=SERVE_MODE_RUNS)
    ms_e = median_ms(lambda: int8_apply(qp, x32, cfg), runs=SERVE_MODE_RUNS)
    print(f"phase 7 exact path at batch {b}: {ms_k:.2f} ms per forward on K7 + K8, "
          f"{ms_e:.2f} ms plain (median of {SERVE_MODE_RUNS}) on {card}", flush=True)

    # (d) the mixed chains at batch 32 against their plain twins
    preset = {"attn_dtype": bf16, "compute_dtype": bf16, "gelu_approx": True}
    for mode, attn_impl in (("mixed_none", "pallas_fused"), ("mixed", "pallas")):
        fa.flash_attention_qkv.launches = fa.fused_attention_qkv.launches = 0
        fs.int8_dense.launches = fs.int8_dense_gelu_q.launches = 0
        got = int8_apply(qp, x32, cfg, fused=mode, attn_impl=attn_impl, **preset)
        torch.cuda.synchronize()
        counts = (fs.int8_dense.launches, fs.int8_dense_gelu_q.launches,
                  fa.fused_attention_qkv.launches, fa.flash_attention_qkv.launches)
        # the twin with the chain's tensor-core attention as its attention
        # stage: K3 (pallas_fused) or the bf16 K8 (pallas)
        k3 = attn_impl == "pallas_fused"
        with k3_in_plain_chain(fa) if k3 else k8_in_plain_chain(fa, la) as calls:
            want = int8_apply(qp, x32, cfg, fused=mode + "_plain", attn_impl=attn_impl, **preset)
        twin = f"{mode}_plain with {'K3' if k3 else 'K8'}'s attention"
        ms = median_ms(lambda: int8_apply(qp, x32, cfg, fused=mode, attn_impl=attn_impl,
                                          **preset), runs=SERVE_MODE_RUNS)
        print(f"phase 7 {mode} + {attn_impl} at batch {b}: launches int8_dense {counts[0]} "
              f"gelu_q {counts[1]} attention_q {counts[2]} flash_attention {counts[3]}; "
              f"identical to {twin} {torch.equal(got, want)}; {ms:.2f} ms per forward "
              f"(median of {SERVE_MODE_RUNS})", flush=True)
        expect = (0, 0, depth, 0) if mode == "mixed_none" else (2 * depth, depth, 0, depth)
        if counts != expect or len(calls) != depth or not torch.equal(got, want):
            fail(f"{mode} + {attn_impl}: launches {counts} (expected {expect}), {len(calls)} "
                 f"attention calls in the twin, identical to {twin} {torch.equal(got, want)}")
        if mode == "mixed":
            launches["flash_attention bf16"] = counts[3]
            plain = int8_apply(qp, x32, cfg, fused="mixed_plain", attn_impl=attn_impl, **preset)
            rel = rel_l2(got.float(), plain.float())
            print(f"phase 7 {mode} + {attn_impl} at batch {b}: K8 per call within the "
                  f"tolerance (worst |diff| {max(calls):.3e}); logits vs the all-plain twin rel "
                  f"L2 {rel:.3e} (bound {MIXED_CHAIN_REL_L2}), top-1 agreement "
                  f"{float((got.argmax(-1) == plain.argmax(-1)).float().mean()):.4f}", flush=True)
            if rel > MIXED_CHAIN_REL_L2:
                fail(f"{mode} + {attn_impl}: logits rel L2 {rel:.3e} from the all-plain twin")

    # (e) K9a / K9b at batch 256: logits bit-identical to the megamodel
    # kernel chain (phase 3 holds it identical to the plain chain with K3's
    # attention) and within CHAIN_REL_L2 of the all-plain chain; the
    # megamodel chain identical to phase 3's
    x256 = prep(torch.from_numpy(images[:SERVE_B]))
    chain = int8_apply(qp, x256, cfg, fused="megamodel", **preset)
    same_p3 = np.array_equal(chain.cpu().numpy(), ctx["logits"][:SERVE_B])
    plain = int8_apply(qp, x256, cfg, fused="megamodel_plain", **preset)
    res = (ctypes.c_int * 6)()
    stages = (fa.fused_attention_qkv, fs.int8_dense_gelu_q, fs.int8_dense_resid_ln_q)
    for mode, wrapper, want in (("megablock:4:tight", bk.megablock_forward, depth),
                                ("megamodel_res:4:tight", bk.megamodel_res_forward, 1)):
        for w in (wrapper, *stages):
            w.launches = 0
        got = int8_apply(qp, x256, cfg, fused=mode, **preset)
        torch.cuda.synchronize()
        n_launch, n_chain = wrapper.launches, sum(w.launches for w in stages)
        launches[wrapper] = n_launch
        again = torch.equal(got, int8_apply(qp, x256, cfg, fused=mode, **preset))
        rel = rel_l2(got.float(), plain.float())
        _build.load().call("qvt_megablock_residency", n_tok, heads, hd, 1,
                           ctypes.addressof(res))
        print(f"phase 7 {mode} at batch {SERVE_B}: {n_launch} cooperative launches "
              f"({res[0]} blocks of {res[2]} threads per SM x {res[1]} SMs, {res[3]} bytes of "
              f"shared memory), the chain's kernels {n_chain}; logits identical to the "
              f"megamodel kernel chain {torch.equal(got, chain)}, two launches identical "
              f"{again}, vs the all-plain chain rel L2 {rel:.3e} (bound {CHAIN_REL_L2}) (the "
              f"megamodel chain identical to phase 3's {same_p3})", flush=True)
        if (n_launch != want or n_chain or not torch.equal(got, chain) or not again
                or rel > CHAIN_REL_L2 or not same_p3):
            fail(f"{mode}: {n_launch} launches (expected {want}), chain kernels {n_chain}, "
                 f"identical to the kernel chain {torch.equal(got, chain)}, two launches "
                 f"identical {again}, rel L2 vs plain {rel:.3e}, the chain to phase 3 {same_p3}")
    times = {}
    for mode in ("megamodel", "megablock:4:tight", "megamodel_res:4:tight") * 2:
        ms = median_ms(lambda: int8_apply(qp, x256, cfg, fused=mode, **preset),
                       runs=SERVE_MODE_RUNS)
        times.setdefault(mode, []).append(ms)
    bound_ms, bound_by = roofline(*chain_works(SERVE_B, n_tok, d, mlp, heads, hd, depth,
                                               3 * cfg.patch_size ** 2, cfg.num_classes))
    print(f"phase 7 ms per batch-{SERVE_B} forward (CUDA events, median of {SERVE_MODE_RUNS}, "
          f"two turns each): " + ", ".join(f"{k} {' / '.join(f'{v:.2f}' for v in vs)}"
                                           for k, vs in times.items())
          + f"; bound {bound_ms:.4f} ms ({bound_by}) on {card}", flush=True)

    for k in kernels:
        w = k["wrapper"]
        k["launches"] = (launches["flash_attention bf16"]
                         if w is fa.flash_attention_qkv and "bf16" in k["name"] else launches[w])
    return kernels

def _replay(torch, make, steps, counters):
    """The same ``steps`` through the kernels and under ``reference_impl()``
    on a module from one seed: ([metrics], params) of each run, and the
    ``counters``' launches of the kernel run."""
    from qat_vit_tpu_torch.ops._cuda import reference_impl

    runs = []
    for plain in (False, True):
        state, batch, hp = make()
        for c in counters:
            c.launches = 0
        with reference_impl() if plain else contextlib.nullcontext():
            ms = [{k: float(v) for k, v in step(state, batch, hp).items()} for step in steps]
        torch.cuda.synchronize()
        if not plain:
            launches = [c.launches for c in counters]
        runs.append((ms, torch.cat([p.detach().flatten() for p in state.module.parameters()])))
        del state
    return runs, launches


def phase_kernel_forms(torch, np, fs, fa, fat, la, det):
    """The last kernel forms: K6's int8 score dots (``i8``: PLAIN_Q8 and the
    int8-score attention, then the chain on phase 5's export) and the f32
    forms of kernels A and B (K1) and of K5a / K5b."""
    from qat_vit_tpu_torch.serve.int8_detect import int8_detect_apply, make_int8_detect_forward

    dev = torch.device("cuda")
    bf16, f32t = torch.bfloat16, torch.float32
    rng = np.random.default_rng(SEED + 8)
    card = card_line()
    d, heads, hd, n = 576, 9, 64, 2305
    b = DET_REF_B
    m = b * n
    out_q = {"scale": torch.tensor(0.05), "zero_point": torch.tensor(131.0)}
    in_q = {"scale": torch.tensor(0.02), "zero_point": torch.tensor(121.0)}
    x_qkv = rand_int8(torch, np, rng, dev, b, n, d)
    l_qkv = rand_layer(torch, np, rng, dev, d, 3 * d)
    qk8 = rand_int8(torch, np, rng, dev, b, n, 2 * d)
    qkv = torch.from_numpy(rng.normal(0, 1.0, (b, n, 3 * d)).astype(np.float32)).to(dev)
    do = torch.from_numpy(rng.normal(0, 1.0, (b, n, d)).astype(np.float32)).to(dev)
    fq = {"qs": torch.tensor([4.2 / 255, 127.0], dtype=f32t, device=dev), "in_fq": (0, 255)}
    qkv_long = torch.from_numpy(rng.normal(0, 1.0, (1, K5A_LONG_N, 3 * d)).astype(
        np.float32)).to(dev)
    # K5b in f32 at JAX's cap of 4,096 tokens, with padded queries
    qkv_cap = torch.from_numpy(rng.normal(0, 1.0, (1, K5B_CAP_N, 3 * d)).astype(
        np.float32)).to(dev)
    do_cap = torch.from_numpy(rng.normal(0, 1.0, (1, K5B_CAP_N, d)).astype(np.float32)).to(dev)
    # K5a and K5b in f32 run kernel A's and kernel B's f32 kernels
    k5a_f32 = {"source": F32_ATTENTION, "repeat": True}
    q8_attn = [{"ops": 2 * b * heads * n * n * hd, "type": "int8",  # the int8 score dot
                "bytes": b * n * 2 * d + 2 * b * n * d + b * n * d},
               {"ops": 2 * b * heads * n * n * hd, "type": "bf16", "bytes": 0}]  # p @ v
    cases = [
        (f"int8_gemm:plain_q8 qkv [{m}x{d}]@[{d}x{3 * d}] + int8 q,k", fs.int8_dense_q8,
         fs.int8_dense_q8_plain, (x_qkv, l_qkv, in_q, out_q), {},
         "qat_vit_tpu/ops/long_block_kernel.py:146", gemm_work(m, d, 3 * d, 2, m * 2 * d),
         int_mm(torch, x_qkv, l_qkv)),
        (f"attention_long_q8 (i8) [{b}x{n}x{3 * d}] {heads} heads", la.long_attention_q8,
         la.long_attention_q8_plain, (qk8, qkv.to(bf16), heads, hd), {"out_q": out_q},
         "qat_vit_tpu/ops/long_block_kernel.py:179", q8_attn, None, {"int8_bound": True}),
        (f"attention_long f32 [{b}x{n}x{3 * d}] {heads} heads", la.long_attention_qkv,
         la.long_attention_qkv_plain, (qkv, heads, hd), {}, "qat_vit_tpu/ops/long_attention.py:63",
         attention_work(b, n, heads, hd, 4, in_bytes=4, op_type="f32"),
         sdpa_forward(torch, qkv, heads, hd), k5a_f32),
        # past the earlier f32 kernel's plan (6,048 tokens at hd 64)
        (f"attention_long f32 [1x{K5A_LONG_N}x{3 * d}] {heads} heads n_valid "
         f"{K5A_LONG_N - 10}", la.long_attention_qkv, la.long_attention_qkv_plain,
         (qkv_long, heads, hd), {"n_valid": K5A_LONG_N - 10},
         "qat_vit_tpu/ops/long_attention.py:63",
         attention_work(1, K5A_LONG_N, heads, hd, 4, in_bytes=4, op_type="f32"),
         sdpa_forward(torch, qkv_long, heads, hd), k5a_f32),
        (f"attention_long_bwd f32 [{b}x{n}x{3 * d}] {heads} heads", la.long_attention_bwd,
         la.long_attention_bwd_plain, (qkv, do, heads, hd), {},
         "qat_vit_tpu/ops/long_attention.py:173",
         attention_work(b, n, heads, hd, backward=True, in_bytes=4, op_type="f32"),
         sdpa_backward(torch, qkv, do, heads, hd), k5a_f32),
        (f"attention_long_bwd f32 [1x{K5B_CAP_N}x{3 * d}] {heads} heads n_valid "
         f"{K5B_CAP_N - 6}", la.long_attention_bwd, la.long_attention_bwd_plain,
         (qkv_cap, do_cap, heads, hd), {"n_valid": K5B_CAP_N - 6},
         "qat_vit_tpu/ops/long_attention.py:173",
         attention_work(1, K5B_CAP_N, heads, hd, backward=True, in_bytes=4, op_type="f32"),
         sdpa_backward(torch, qkv_cap, do_cap, heads, hd), k5a_f32),
    ]
    kernels = check_kernels(torch, cases, "phase 8", exact=True,
                            slow_plain=(la.long_attention_q8_plain, la.long_attention_qkv_plain,
                                        la.long_attention_bwd_plain))
    del x_qkv, qk8, qkv, qkv_long, qkv_cap, do, do_cap, cases
    kernels += f32_attention_in_child(fa, fat)

    # the i8 chain on phase 5's export at batch 8 x 4 queries: against its
    # plain twin and the exact path, ms per forward beside megamodel_long
    export, cfg, x, q, exact = det["export"], det["cfg"], det["x"], det["q"], det["exact"]
    depth = cfg.depth
    i8 = make_int8_detect_forward(cfg, dev, fused="megamodel_long:512:256:i8")
    wrappers = (fs.int8_dense, fs.int8_dense_q8, fs.int8_dense_resid_ln_q, fs.int8_dense_gelu_q,
                fs.ln_quantize, la.long_attention_q8, la.long_attention_q)
    for w in wrappers:
        w.launches = 0
    out = i8(export, x, q)
    torch.cuda.synchronize()
    launches = {w: w.launches for w in wrappers}
    want = {fs.int8_dense: 1, fs.int8_dense_q8: depth, fs.int8_dense_resid_ln_q: 2 * depth,
            fs.int8_dense_gelu_q: depth, fs.ln_quantize: 1, la.long_attention_q8: depth,
            la.long_attention_q: 0}
    counts = ", ".join(f"{w.__name__} {launches[w]}" for w in wrappers)
    print(f"phase 8 the i8 chain (megamodel_long:512:256:i8): {sum(launches.values())} launches "
          f"per batch-{DET_B} forward ({counts})", flush=True)
    if launches != want:
        fail(f"the i8 chain's launches {launches}, expected {want}")
    plain = int8_detect_apply(export, x, cfg, q, **{
        **i8.options, "fused": "megamodel_long_plain:512:256:i8"})
    rels = {k: rel_l2(out[k].float(), plain[k].float()) for k in plain}
    print(f"phase 8 the i8 chain at batch {DET_B} vs its plain twin: rel L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f" ({'within' if max(rels.values()) <= LONG_CHAIN_REL_L2 else 'NOT within'} the K6 "
          f"chain's bound {LONG_CHAIN_REL_L2}; printed, not held)", flush=True)
    with kernel_attention_in_plain_chain(la) as calls:
        hybrid = int8_detect_apply(export, x, cfg, q, **{
            **i8.options, "fused": "megamodel_long_plain:512:256:i8"})
    same = all(torch.equal(out[k], hybrid[k]) for k in plain) and len(calls) == depth
    box_err = float((out["pred_boxes"] - exact["pred_boxes"]).abs().mean())
    corr = {k: float(np.corrcoef(out[k].flatten().cpu().numpy(),
                                 exact[k].flatten().cpu().numpy())[0, 1])
            for k in ("logits", "objectness_logits")}
    print(f"phase 8 the i8 chain at batch {DET_B} identical to its plain twin with K6a's "
          f"attention (per block within the int8 bound, exact shares "
          + ", ".join(f"{e:.7f}" for _, e in calls) + f"): {same}; "
          f"vs the exact f32 path: pred_boxes mean |err| {box_err:.3e} (bound "
          f"{DET_BOX_MEAN_ERR}), corr logits {corr['logits']:.5f} objectness "
          f"{corr['objectness_logits']:.5f} (bound > {DET_CORR})", flush=True)
    if not same or box_err > DET_BOX_MEAN_ERR or min(corr.values()) <= DET_CORR:
        fail(f"the i8 chain: identical to the plain twin with K6a's attention {same}, box err "
             f"{box_err:.3e}, corr {corr}")
    del out, plain, hybrid
    bf = make_int8_detect_forward(cfg, dev)
    times = {}
    for name, fwd in (("i8", i8), ("megamodel_long", bf), ("megamodel_long", bf), ("i8", i8)):
        times.setdefault(name, []).append(median_ms(lambda: fwd(export, x, q),
                                                    runs=DET_TIMING_RUNS))
    print(f"phase 8 ms per batch-{DET_B} forward with {DET_Q} queries (CUDA events, median of "
          f"{DET_TIMING_RUNS}, two turns each): " + ", ".join(
              f"{k} {' / '.join(f'{v:.2f}' for v in vs)}" for k, vs in times.items())
          + f" on {card}", flush=True)

    replays = replay_f32_steps(torch, np, fa, fat, la, dev)
    for k in kernels:
        w = k["wrapper"]
        k["launches"] = launches[w] if w in launches else replays[w]
    return kernels

def phase_checkpoints(torch, np, fs, serve_ctx, ckpt):
    """Checkpoints on the card, at full width: phase 3's ViT-S/16 export
    written by ``save_checkpoint`` and served back through
    ``Int8Predictor.from_checkpoint`` at batch 256 (logits identical to phase
    3's in-memory predictor, K2d launched); phase 4's float student written
    as a msgpack of its params and its teacher as a timm-layout ``.pth``
    (``params_to_timm_vit``), both read by a new ``KDQATTrainer``
    (``student_ckpt``, ``teacher_ckpt``): identical parameters, identical
    teacher logits."""
    import tempfile

    from qat_vit_tpu_torch.models.jax_params import state_dict_to_params
    from qat_vit_tpu_torch.models.torch_convert import params_to_timm_vit
    from qat_vit_tpu_torch.serve.predictor import Int8Predictor
    from qat_vit_tpu_torch.train.config import load_hparams
    from qat_vit_tpu_torch.train.trainer import KDQATTrainer
    from qat_vit_tpu_torch.utils.checkpoint import save_checkpoint

    dev = torch.device("cuda")
    cfg, images = serve_ctx["cfg"], serve_ctx["images"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "best_converted.msgpack")
        t0 = time.perf_counter()
        save_checkpoint(path, serve_ctx["export"], {"format": "int8-weights+qparams"})
        t_save = time.perf_counter() - t0
        fs.ln_quantize.launches = 0
        t0 = time.perf_counter()
        pred = Int8Predictor.from_checkpoint(path, cfg, device=dev, batch_size=SERVE_B)
        t_load = time.perf_counter() - t0
        logits = pred.logits(images)
        torch.cuda.synchronize()
        n_k2d = fs.ln_quantize.launches
        same = np.array_equal(logits, serve_ctx["logits"])
        print(f"phase 9 the ViT-S/16 int8 export: written in {t_save:.2f} s "
              f"({os.path.getsize(path) / 2 ** 20:.1f} MiB), read into Int8Predictor."
              f"from_checkpoint on the card in {t_load:.2f} s; logits of {len(images)} images at "
              f"batch {SERVE_B} identical to phase 3's in-memory predictor {same}; ln_quantize "
              f"launches {n_k2d} (preset {pred.options.get('fused')})", flush=True)
        if not same or n_k2d == 0:
            fail(f"from_checkpoint: logits identical {same}, ln_quantize launches {n_k2d}")

        spath = os.path.join(tmp, "student.msgpack")
        save_checkpoint(spath, {"params": state_dict_to_params(ckpt["student"])})
        tpath = os.path.join(tmp, "teacher.pth")
        timm = params_to_timm_vit(state_dict_to_params(ckpt["teacher"]), ckpt["teacher_cfg"])
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16)
                    for k, v in timm.items()}, tpath)
        hp = load_hparams(None)
        hp.update(batch_size=TRAIN_B, eval_batch_size=256, epochs=2, seed=SEED,
                  student_ckpt=spath, teacher_ckpt=tpath)
        t0 = time.perf_counter()
        t = KDQATTrainer(hp, device=dev, data=ckpt["data"])
        t_build = time.perf_counter() - t0
        got = t.student_float.state_dict()
        same_s = sorted(got) == sorted(ckpt["student"]) and all(
            torch.equal(got[k].cpu(), v) for k, v in ckpt["student"].items())
        same_t = np.array_equal(t._teacher_forward(ckpt["images"]), ckpt["teacher_logits"])
        mib = {p: os.path.getsize(p) / 2 ** 20 for p in (spath, tpath)}
        print(f"phase 9 KDQATTrainer(student_ckpt=msgpack of {mib[spath]:.1f} MiB, "
              f"teacher_ckpt=timm .pth of {mib[tpath]:.1f} MiB) built "
              f"in {t_build:.2f} s: the student's parameters identical to phase 4's {same_s}; the "
              f"teacher's logits on {len(ckpt['images'])} images identical to phase 4's "
              f"teacher's {same_t}", flush=True)
        if not (same_s and same_t):
            fail(f"weights from files: student identical {same_s}, teacher logits {same_t}")
        del t, pred


# the f32 kernels A and B in phase 8: ViT-S at batch 8 and 256, N 512 at 6
# heads of 64 and of 128 (JAX's K1 gate admits 6 heads up to N 512), N 1,248
# at one head of 128 (the most it admits); (batch, tokens, heads, hd)
F32_ATTENTION_SHAPES = ((8, 197, 6, 64), (256, 197, 6, 64), (2, 512, 6, 64), (2, 512, 6, 128),
                        (1, 1248, 1, 128))


F32_CHILD = "--f32-attention"


def f32_attention_in_child(fa, fat):
    """Phase 8's f32 kernels A and B (:func:`f32_attention_phase`) in a
    fresh process of this script. Late in one process, after many profiled
    sessions, torch.profiler was seen to drop device events (phase 8's
    kernel device times read 30-50% under a fresh process's, then none),
    so the device times and the profile come from a process that has
    profiled nothing before. Its kernel records, as ``check_kernels``
    returns them, with their wrappers."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), F32_CHILD],
                       capture_output=True, text=True, timeout=900)
    lines = r.stdout.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    if r.returncode or not lines:
        print(r.stderr[-4000:], file=sys.stderr, flush=True)
        fail(f"phase 8's f32 kernels A and B (a child process) exited {r.returncode}")
    records = json.loads(lines[-1])
    for k in records:
        k["wrapper"] = {"fwd": fa.attention_fwd, "bwd": fat.attention_bwd}[k.pop("kind")]
    return records


def f32_attention_phase(torch, np, fa, fat):
    """The f32 kernels A and B against their plain versions at
    ``F32_ATTENTION_SHAPES`` (:func:`f32_attention_cases`), then one profiled
    call of each (:func:`f32_kernel_b_profile`); prints the kernel records
    as a JSON list, last."""
    rng = np.random.default_rng(SEED + 8)
    fq = {"qs": torch.tensor([4.2 / 255, 127.0], dtype=torch.float32, device="cuda"),
          "in_fq": (0, 255)}
    f32_kernel_b_profile(torch, np, fa, fat)
    results = check_kernels(torch, f32_attention_cases(torch, np, fa, fat, rng, fq), "phase 8",
                            exact=True,
                            slow_plain=(fa.attention_fwd_plain, fat.attention_bwd_plain))
    for k in results:
        k["kind"] = "fwd" if k.pop("wrapper") is fa.attention_fwd else "bwd"
    print(json.dumps(results), flush=True)


def f32_attention_cases(torch, np, fa, fat, rng, fq):
    """``check_kernels``' cases of the f32 kernels A and B
    (``csrc/attention_f32.cu``) at ``F32_ATTENTION_SHAPES``, ``in_fq`` off
    and on: bit-identical to their plain versions, two launches identical,
    kernel B's STE zero set the plain version's, device times beside SDPA's
    forward and autograd backward."""
    dev = torch.device("cuda")
    cases = []
    for b, n, heads, hd in F32_ATTENTION_SHAPES:
        qkv = torch.from_numpy(rng.normal(0, 1.0, (b, n, 3 * heads * hd)).astype(
            np.float32)).to(dev)
        do = torch.from_numpy(rng.normal(0, 1.0, (b, n, heads * hd)).astype(np.float32)).to(dev)
        shape = f"[{b}x{n}x{3 * heads * hd}] {heads} heads"
        fwd = attention_work(b, n, heads, hd, 4, in_bytes=4, op_type="f32")
        bwd = attention_work(b, n, heads, hd, backward=True, in_bytes=4, op_type="f32")
        for name, kw in (("", {}), (":in_fq", fq)):
            extra = {"source": F32_ATTENTION, "repeat": True, "device": True}
            cases.append((f"attention_fwd{name} f32 {shape}", fa.attention_fwd,
                          fa.attention_fwd_plain, (qkv, heads, hd), kw,
                          "qat_vit_tpu/ops/flash_attention.py:125", fwd,
                          sdpa_forward(torch, qkv, heads, hd), extra))
            cases.append((f"attention_bwd{name and ':in_fq+ste'} f32 {shape}", fat.attention_bwd,
                          fat.attention_bwd_plain, (qkv, do, heads, hd), kw,
                          "qat_vit_tpu/ops/flash_attention_train.py:48", bwd,
                          sdpa_backward(torch, qkv, do, heads, hd),
                          {**extra, "ste": (qkv, kw or None)}))
    return cases


def f32_kernel_b_profile(torch, np, fa, fat):
    """One f32 kernel-A and one kernel-B call at ViT-S ``[8, 197, 1152]``
    under torch.profiler: fails unless they show kernel A's kernel and
    kernel B's rows and keys kernels, once each."""
    rng = np.random.default_rng(SEED + 10)
    qkv = torch.from_numpy(rng.normal(0, 1, (8, 197, 1152)).astype(np.float32)).cuda()
    do = torch.from_numpy(rng.normal(0, 1, (8, 197, 384)).astype(np.float32)).cuda()

    def fn():
        return fa.attention_fwd(qkv, 6, 64), fat.attention_bwd(qkv, do, 6, 64)

    fn()
    torch.cuda.synchronize()
    groups, busy, _, launched, counts = device_breakdown(torch, fn)
    want = {"kernel A f32": 1, "kernel B f32 rows": 1, "kernel B f32 keys": 1}
    print("phase 8 the f32 kernels A and B at [8x197x1152] under torch.profiler: "
          + ", ".join(f"{g} {counts[g]} kernel(s) {groups[g]:.4f} ms" for g in want)
          + f"; {launched} kernels, busy {busy:.4f} ms", flush=True)
    if any(counts[g] != k for g, k in want.items()):
        fail(f"the f32 kernels A and B under the profiler: {dict(counts)}, expected {want}")


def replay_f32_steps(torch, np, fa, fat, la, dev):
    """Depth-2 f32 fast_math train steps (one float, one QAT) at batch 2:
    ViT-S through kernels A and B, OWLv2-pruned through K5a / K5b, each
    through the kernels and under ``reference_impl()`` (must be identical);
    the kernels' launches by wrapper."""
    from qat_vit_tpu_torch.models.owlv2_detect import create_detector
    from qat_vit_tpu_torch.models.registry import create_student
    from qat_vit_tpu_torch.train import detect_steps, steps

    rng = np.random.default_rng(SEED + 9)
    hp = {"kd_alpha": 0.5, "kd_temperature": 4.0, "label_smoothing": 0.1, "det_box_weight": 1.0,
          "det_obj_weight": 0.25}
    images = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)).to(dev)

    def vit():
        s = create_student("vit", depth=2, fast_math=True, fq_in_kernel=True,
                           generator=torch.Generator().manual_seed(SEED), device=dev).module
        batch = {"image": images, "label": torch.tensor([1, 7], device=dev),
                 "teacher_logits": torch.from_numpy(
                     np.random.default_rng(SEED).normal(0, 2, (2, 10)).astype(np.float32)).to(dev)}
        return (steps.TrainState(s, steps.make_optimizer(s.parameters(), 1e-3, 1e-2)), batch,
                steps.loss_hparams(hp, dev))

    def owl():
        s, c = create_detector(pruned=True, qat_wrapper=True, depth=2, fast_math=True,
                               generator=torch.Generator().manual_seed(SEED), device=dev)
        p = c.num_patches
        r = np.random.default_rng(SEED)
        batch = {"image": images,
                 "query_embeds": torch.from_numpy(r.normal(0, 1, (2, DET_Q, 512))
                                                  .astype(np.float32)).to(dev),
                 "t_logits": torch.from_numpy(r.normal(0, 2, (2, p, DET_Q))
                                              .astype(np.float32)).to(dev),
                 "t_boxes": torch.from_numpy(r.uniform(0, 1, (2, p, 4))
                                             .astype(np.float32)).to(dev),
                 "t_obj": torch.from_numpy(r.normal(0, 2, (2, p)).astype(np.float32)).to(dev)}
        return (steps.TrainState(s, steps.make_optimizer(s.parameters(), 1e-3, 1e-2)), batch,
                detect_steps.detect_loss_hparams(hp, dev))

    replays = {}
    for name, make, mk_step, px, counters in (
            ("ViT-S/16", vit, steps.make_train_step, 224, (fa.attention_fwd, fat.attention_bwd)),
            ("OWLv2-pruned", owl, detect_steps.make_detect_train_step, 768,
             (la.long_attention_qkv, la.long_attention_bwd))):
        st = [mk_step(None, qat=qat, image_size=px) for qat in (False, True)]
        ((mk, pk), (mp, pp)), counts = _replay(torch, make, st, counters)
        same = mk == mp and torch.equal(pk, pp)
        print(f"phase 8 {name} at depth 2, f32 fast_math, one float and one QAT step at batch "
              f"2: losses through the kernels {[m['train_loss'] for m in mk]!r}, through "
              f"reference_impl() {[m['train_loss'] for m in mp]!r}; metrics and parameters "
              f"identical {same}; launches {counters[0].__name__} {counts[0]} "
              f"{counters[1].__name__} {counts[1]}", flush=True)
        want = [4, 4] if counters[0] is fa.attention_fwd else [4, 8]  # K5b: 2 per call
        if not same or counts != want:
            fail(f"the {name} f32 replay: identical {same}, launches {counts} (expected {want})")
        replays.update(zip(counters, counts))
    return replays


# phase 10: the CLI's arguments (ViT-S/16 from a random-init ViT-B/16 teacher,
# two epochs of 4 steps at batch 256, QAT from epoch 1, 2 eval batches of
# 512); the in-process trainers' batch for resume and the observer checks
ENTRY_ARGS = ["--epochs", "2", "--qat-start-epoch", "1", "--batch-size", "256",
              "--limit-train-batches", "4", "--limit-eval-batches", "2"]
ENTRY_RESUME_B, ENTRY_INTERVAL, ENTRY_QAT_STEPS, ENTRY_STRIDE = 32, 4, 8, 4
ENTRY_METRICS = {"train_loss", "train_loss_ce", "train_loss_kd", "qat_acc", "quant_acc",
                 "imgs_per_sec", "qat_enabled", "final_quant_acc"}
ENTRY_FILES = ["effective_hparams.yaml", "best_qat.msgpack", "best_converted.msgpack",
               "resume_state.msgpack"]


def run_cli(root, args, log, timeout=600):
    """``python -m qat_vit_tpu_torch.train.trainer ARGS`` in a child process
    from the checkout, its output into ``log``; fails unless it exits 0."""
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, "-m", "qat_vit_tpu_torch.train.trainer", *args],
                            cwd=root, stdout=f, stderr=subprocess.STDOUT, timeout=timeout).returncode
    if rc != 0:
        with open(log) as f:
            print("".join(f.readlines()[-40:]), file=sys.stderr, flush=True)
        fail(f"the training CLI exited {rc}: {args}")
    return time.perf_counter() - t0


def trace_kernels(prof_dir):
    """Device kernels by group (``kernel_group``) in the Chrome traces that
    ``utils.profiling.trace`` wrote into ``prof_dir``."""
    import collections

    counts = collections.Counter()
    for name in os.listdir(prof_dir):
        if name.endswith(".pt.trace.json"):
            with open(os.path.join(prof_dir, name)) as f:
                for e in json.load(f).get("traceEvents", []):
                    if e.get("cat") == "kernel":
                        counts[kernel_group(e.get("name", ""))] += 1
    return counts


def observer_stats(module):
    return {k: v.clone() for k, v in module.state_dict().items() if k.endswith("_val")}


def train_batches(torch, np, data, b, n, dev, seed):
    """``n`` device batches of ``b`` images with random cached-teacher logits."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sel = np.arange(i * b, (i + 1) * b) % len(data["train_images"])
        out.append({"image": torch.from_numpy(data["train_images"][sel]).to(dev),
                    "label": torch.from_numpy(data["train_labels"][sel].astype(np.int64)).to(dev),
                    "teacher_logits": torch.from_numpy(
                        rng.normal(0, 2, (b, 10)).astype(np.float32)).to(dev)})
    return out


def phase_entry_points(torch, np, fs, fa, fat, la, keep_dir=None):
    """The port's two training entry points at full width: the CLI as a user
    runs it (classification in a child process, detection in this one),
    resume, ``observer_interval`` and ``observer_stride``, the native loader.
    The CLI's ``best_converted.msgpack`` (with its sidecar) is copied into
    ``keep_dir`` for phase 12."""
    import shutil
    import tempfile

    from qat_vit_tpu_torch.data import native_loader
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.models import vit as vit_module
    from qat_vit_tpu_torch.serve.predictor import Int8Predictor
    from qat_vit_tpu_torch.tracking import SqliteTracker
    from qat_vit_tpu_torch.train import trainer as tr
    from qat_vit_tpu_torch.utils.checkpoint import load_checkpoint, load_metadata

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.empty_cache()  # the child process needs the memory the earlier phases cached
    root = os.path.dirname(os.path.abspath(__file__))
    card = card_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    try:
        out, db = os.path.join(tmp, "out"), os.path.join(tmp, "mlflow.db")
        common = ["--output-dir", out, "--mlflow-uri", f"sqlite:///{db}",
                  "--data-dir", os.path.join(tmp, "no_cifar")]
        # (a) the classification CLI
        secs = run_cli(root, ENTRY_ARGS + common + ["--profile-dir", os.path.join(tmp, "prof")],
                       os.path.join(tmp, "cli.log"))
        missing = [f for name in ENTRY_FILES for f in (name, name + ".json")
                   if not os.path.isfile(os.path.join(out, f))
                   and not f.startswith("effective_hparams.yaml.")]
        store = SqliteTracker(f"sqlite:///{db}", tr.DEFAULT_HPARAMS["experiment"], create=False)
        runs = store.runs()
        keys = {m["key"] for m in store.metrics(runs[0]["run_id"])} if runs else set()
        if missing or len(runs) != 1 or runs[0]["status"] != "FINISHED" or not ENTRY_METRICS <= keys:
            fail(f"the CLI's artifacts: missing {missing}, runs {runs}, metrics {sorted(keys)}")
        run_id = runs[0]["run_id"]
        ips = sorted((m["step"], m["value"]) for m in store.metrics(run_id, "imgs_per_sec"))
        mem = [m["value"] for m in store.metrics(run_id, "system/device_memory_usage_megabytes")]
        groups = trace_kernels(os.path.join(tmp, "prof"))
        want = {"K3 / kernel A": 48, "kernel B rows": 48, "kernel B keys": 48}
        print(f"phase 10 the training CLI (ViT-S/16 from a random-init ViT-B/16, 2 epochs of 4 "
              f"steps at batch 256, QAT from epoch 1) in a child process: exit 0 in {secs:.1f} s; "
              f"the artifact set written; one FINISHED run with the reference's metric names; "
              f"img/s by epoch {[(e, round(v, 1)) for e, v in ips]} (host clock over the epoch, "
              f"first steps included) on {card}; device memory sampled "
              + (f"{min(mem):.0f}-{max(mem):.0f} MB" if mem else "never (runs under 10 s)")
              + "; the profiled QAT epoch's trace: "
              + ", ".join(f"{g} {groups[g]}" for g in want) + " kernels", flush=True)
        if any(groups[g] != n for g, n in want.items()):
            fail(f"the profiled QAT epoch ran {dict(groups)}, expected {want}")
        meta = load_metadata(os.path.join(out, "best_converted.msgpack"))
        if meta.get("format") != "int8-weights+qparams" or meta.get("epoch") != 1:
            fail(f"best_converted.msgpack's metadata: {meta}")
        if keep_dir is not None:
            for f in ("best_converted.msgpack", "best_converted.msgpack.json"):
                shutil.copy(os.path.join(out, f), keep_dir)

        # (b) the CLI again, resumed from epoch 1's file with one more epoch
        secs = run_cli(root, ENTRY_ARGS[2:] + ["--epochs", "3", "--resume",
                                               os.path.join(out, "resume_state.msgpack")]
                       + common, os.path.join(tmp, "resume.log"))
        new = [r for r in store.runs() if r["run_id"] != run_id]
        steps = sorted({m["step"] for m in store.metrics(new[0]["run_id"])
                        if m["key"] in ENTRY_METRICS - {"final_quant_acc"}}) if len(new) == 1 else None
        resumed = load_checkpoint(os.path.join(out, "resume_state.msgpack"))
        print(f"phase 10 the CLI with --resume (from epoch 1's resume_state.msgpack, --epochs 3) "
              f"in {secs:.1f} s: its run's epoch metrics at steps {steps}, resume file now epoch "
              f"{int(resumed['epoch'])}, step {int(resumed['step'])}", flush=True)
        if steps != [2] or new[0]["status"] != "FINISHED" or int(resumed["epoch"]) != 2:
            fail(f"the resumed CLI run: steps {steps}, runs {new}")

        # (b') resume in this process at batch 32: the loading trainer has the
        # saving one's state, and one more step of each is identical
        student, teacher = vit_models(torch)
        data = synthetic_cifar10(n_train=ENTRY_QAT_STEPS * TRAIN_B, n_test=64, seed=SEED)
        t1 = vit_trainer(torch, data, student, teacher, ENTRY_RESUME_B)
        t1.enable_qat()
        b32 = train_batches(torch, np, data, ENTRY_RESUME_B, 2, dev, SEED + 20)
        t1.next_step_fn()(t1.state, b32[0], t1.loss_hp)
        path = t1.save_resume_state(os.path.join(tmp, "resume32.msgpack"), epoch=0)
        t2 = vit_trainer(torch, data, student, teacher, ENTRY_RESUME_B)
        t2.load_resume_state(path)
        sd1, sd2 = t1.state.module.state_dict(), t2.state.module.state_dict()
        same_state = sd1.keys() == sd2.keys() and all(torch.equal(sd1[k], sd2[k]) for k in sd1)
        same_adam = all(
            all(torch.equal(t1.state.optimizer.adamw.state[p][k],
                            t2.state.optimizer.adamw.state[q][k]) for k in ("step", "exp_avg",
                                                                             "exp_avg_sq"))
            for p, q in zip(t1.state.module.parameters(), t2.state.module.parameters()))
        m1 = t1.next_step_fn()(t1.state, b32[1], t1.loss_hp)
        m2 = t2.next_step_fn()(t2.state, b32[1], t2.loss_hp)
        sd1, sd2 = t1.state.module.state_dict(), t2.state.module.state_dict()
        same_step = all(torch.equal(m1[k], m2[k]) for k in m1) and all(
            torch.equal(sd1[k], sd2[k]) for k in sd1)
        qcfg = t1.student_qat_cfg  # the CLI's student config: the same defaults
        print(f"phase 10 resume in this process at batch {ENTRY_RESUME_B}: after 1 QAT step "
              f"saved and loaded, parameters and observers identical {same_state}, AdamW state "
              f"identical {same_adam}; one more step of each: losses "
              f"{float(m1['train_loss'])!r} / {float(m2['train_loss'])!r}, losses and "
              f"parameters identical {same_step}", flush=True)
        if not (same_state and same_adam and same_step):
            fail("in-process resume: the trainers differ")
        del t1, t2

        # (a') the CLI's int8 export served on the card, through the chain
        serve = (fs.int8_dense, fs.int8_dense_gelu_q, fs.int8_dense_resid_ln_q, fs.ln_quantize,
                 fa.fused_attention_qkv)
        pred = Int8Predictor.from_checkpoint(os.path.join(out, "best_converted.msgpack"), qcfg,
                                             device=dev, batch_size=SERVE_B)
        for w in serve:
            w.launches = 0
        logits = pred.logits(data["train_images"][:SERVE_B])
        torch.cuda.synchronize()
        launched = {w.__name__: w.launches for w in serve}
        print(f"phase 10 the CLI's best_converted.msgpack through Int8Predictor.from_checkpoint "
              f"at batch {SERVE_B}: logits {logits.shape}, finite {np.isfinite(logits).all()}, "
              f"launches {launched}", flush=True)
        if (logits.shape != (SERVE_B, 10) or not np.isfinite(logits).all()
                or not all(launched.values())):
            fail("the CLI's int8 export did not serve finite logits through the serving kernels")

        # (c) observer_interval at batch 256: observe at QAT steps 1 and 5 only
        calls = {"fused": 0, "unfused": 0}
        fused_fn, unfused_fn = vit_module.attention_train_fq, vit_module.attention_train

        def counted(fn, key):
            def wrapper(*a, **k):
                calls[key] += 1
                return fn(*a, **k)
            return wrapper

        t = vit_trainer(torch, data, student, teacher, TRAIN_B, observer_interval=ENTRY_INTERVAL)
        t.enable_qat()
        batches = train_batches(torch, np, data, TRAIN_B, ENTRY_QAT_STEPS, dev, SEED + 21)
        depth = t.student_qat_cfg.depth
        rows, bad = [], []
        vit_module.attention_train_fq = counted(fused_fn, "fused")
        vit_module.attention_train = counted(unfused_fn, "unfused")
        try:
            for i, b in enumerate(batches):
                before = observer_stats(t.state.module)
                calls.update(fused=0, unfused=0)
                fa.attention_fwd.launches = fat.attention_bwd.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.next_step_fn()(t.state, b, t.loss_hp)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                after = observer_stats(t.state.module)
                moved = sum(not torch.equal(before[k], after[k]) for k in before)
                observing = i % ENTRY_INTERVAL == 0
                rows.append((i + 1, observing, moved, dict(calls), fa.attention_fwd.launches,
                             fat.attention_bwd.launches, ms))
                want_calls = ({"fused": depth, "unfused": 0} if observing
                              else {"fused": 0, "unfused": depth})
                if ((moved > 0) != observing or calls != want_calls
                        or fa.attention_fwd.launches != depth
                        or fat.attention_bwd.launches != depth):
                    bad.append(rows[-1])
        finally:
            vit_module.attention_train_fq, vit_module.attention_train = fused_fn, unfused_fn
        obs_ms = [r[-1] for r in rows if r[1]]
        frozen_ms = [r[-1] for r in rows if not r[1]]
        print(f"phase 10 observer_interval {ENTRY_INTERVAL}, {ENTRY_QAT_STEPS} QAT steps at batch "
              f"{TRAIN_B} (step, observes, observer buffers moved, attention calls, kernel A / "
              f"kernel B launches, ms): {rows}; ms per step (host clock between two "
              f"synchronizes): observing {obs_ms} (the first after the switch), frozen mean "
              f"{statistics.mean(frozen_ms):.2f} (median {statistics.median(frozen_ms):.2f}) "
              f"on {card}", flush=True)
        if bad:
            fail(f"observer_interval: steps {bad}")

        # observer_stride 4 beside 1: one QAT step from the same state and batch
        stats = []
        for stride in (1, ENTRY_STRIDE):
            ts = vit_trainer(torch, data, student, teacher, TRAIN_B, observer_stride=stride)
            if ts.student_qat_cfg.quant.activation.observe_stride != stride:
                fail(f"observer_stride {stride}: {ts.student_qat_cfg.quant}")
            ts.enable_qat()
            ts.next_step_fn()(ts.state, batches[0], ts.loss_hp)
            stats.append(observer_stats(ts.state.module))
            del ts
        s1, s4 = stats
        act = [k for k in s1 if "weight_fq" not in k]
        finite = all(bool(torch.isfinite(v)) for v in s4.values())
        rel = max(float((s4[k] - s1[k]).abs() / s1[k].abs().clamp_min(1e-6)) for k in act)
        diff = sum(not torch.equal(s4[k], s1[k]) for k in act)
        same_w = all(torch.equal(s4[k], s1[k]) for k in s1 if "weight_fq" in k)
        site = "blocks.0.attn.qkv.act_fq"
        print(f"phase 10 observer_stride {ENTRY_STRIDE} vs 1, one QAT step at batch {TRAIN_B}: "
              f"statistics finite {finite}; {diff} of {len(act)} activation statistics differ "
              f"(largest relative difference {rel:.3e}; {site} min / max "
              f"{float(s4[site + '.min_val']):.6f} / {float(s4[site + '.max_val']):.6f} against "
              f"{float(s1[site + '.min_val']):.6f} / {float(s1[site + '.max_val']):.6f}); weight "
              f"statistics identical {same_w}", flush=True)
        if not finite or diff == 0 or not same_w:
            fail("observer_stride: the statistics are not finite, or stride 4 changed nothing, "
                 "or a weight observer moved")
        del t, batches, b32, data

        # (d) the detection CLI, in this process (its launches are counted)
        dout = os.path.join(tmp, "det")
        loads = native_loader.gather_batch.native_calls
        la.long_attention_qkv.launches = la.long_attention_bwd.launches = 0
        t0 = time.perf_counter()
        tr.main(["--task", "detection", "--image-size", "768", "--batch-size", "4",
                 "--eval-batch-size", "8", "--epochs", "2", "--qat-start-epoch", "1",
                 "--limit-train-batches", "2", "--limit-eval-batches", "1",
                 "--output-dir", dout, "--mlflow-uri", f"sqlite:///{tmp}/det.db",
                 "--data-dir", os.path.join(tmp, "no_cifar")], device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k5a, k5b = la.long_attention_qkv.launches, la.long_attention_bwd.launches
        export = load_checkpoint(os.path.join(dout, "best_converted_detector.msgpack"))
        dmeta = load_metadata(os.path.join(dout, "best_converted_detector.msgpack"))
        druns = SqliteTracker(f"sqlite:///{tmp}/det.db", tr.DEFAULT_HPARAMS["experiment"],
                              create=False).runs()
        print(f"phase 10 the detection CLI (--task detection, OWLv2-pruned at 768 px from a "
              f"random-init OWLv2-base, 2 epochs of 2 steps at batch 4, eval batch 8) in {secs:.1f} "
              f"s: launches K5a {k5a} (train steps and eval), K5b {k5b} (rows and keys passes of "
              f"4 steps); best_converted_detector.msgpack read back (tower blocks "
              f"{len(export.get('tower', {}).get('blocks', {}))}, metadata {dmeta}); runs "
              f"{[r['status'] for r in druns]}", flush=True)
        n_blocks = len(export.get("tower", {}).get("blocks", {}))
        if (k5b != 2 * 4 * n_blocks or k5a < 4 * n_blocks or n_blocks == 0
                or dmeta.get("format") != "int8-tower+float-heads"
                or [r["status"] for r in druns] != ["FINISHED"]):
            fail(f"the detection CLI: K5a {k5a}, K5b {k5b}, blocks {n_blocks}, {dmeta}, {druns}")

        # (e) the native data plane
        native = native_loader.native_available()
        used = native_loader.gather_batch.native_calls - loads
        print(f"phase 10 native data loader: available {native}, ArrayLoader gathered {used} "
              f"batches through it in the detection run", flush=True)
        if not native or used == 0:
            fail(f"the native data loader: available {native}, batches {used}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)


# phase 11: data parallelism. Two ranks share the card over gloo (NCCL
# refuses two ranks on one GPU); with two cards or more, two ranks also run
# on NCCL, one card each. The ranks are this script (DP_CHILD) started as
# torchrun would start them (parallel.dryrun.launch).
DP_CHILD = "--dp-rank"
DP_ONLY = "--phase-11"  # the build and phase 11 alone, printing no result
DP_WORLD, DP_B, DP_DET_B, DP_DET_DEPTH = 2, 128, 8, 2
DP_FLOAT_STEPS, DP_QAT_STEPS, DP_TIMED_STEPS = 3, 3, 3
DP_TIMEOUT_S = 600
# a DP step against one process's step from the same state on the global
# batch (parallel.dryrun.step_against_one_process): the loss in float steps,
# the global gradient norm before the clip, the parameters after every step
# and the activation observers after every observing step, held to limits
# between port_scripts/dp_bounds.py's readings over 8 seeds on the H100
# (PERF.md §2; a fault's reading is its largest over a run's steps, the
# least of those over the seeds); the ranks identical after every step.
# ViT-S (sound: the largest; faults: no gradient all-reduce / gradients
# summed / observers not reduced):
# - loss 1.44e-7; 1.06e-2 / - / - (the float steps: observers unused)
# - gradient norm 1.18e-4; 1.25e-1 / 1.00 / 3.48e-3
# - parameters 5.36e-5; 2.24e-3 / 3.65e-5 / 2.95e-4 (summed gradients
#   move AdamW's update by its epsilon alone: the gradient norm holds it)
# - observers 0 (min and max are exact); 4.51e-4 / 0 / 6.49e-2
# OWLv2-pruned at depth 2:
# - loss 1.12e-7; every fault 0 (one float step, before any parts)
# - gradient norm 2.69e-4; 1.07e-3 / 1.00 / 3.25e-4
# - parameters 1.05e-5; 1.20e-3 / 5.35e-6 / 2.53e-4
# - observers 0; 0 / 0 / 3.45e-2
# and the ranks apart after every step of the no-all-reduce runs and after
# every QAT step of the unreduced-observer runs, never in sound runs.
DP_LIMITS = {"loss_rel": 1e-4, "params_rel_l2": 1e-4, "grad_norm_rel": 1e-2, "obs_rel": 1e-4}
DP_DET_LIMITS = {"loss_rel": 1e-4, "params_rel_l2": 5e-5, "grad_norm_rel": 5e-4,
                 "obs_rel": 1e-4}


def dp_sum_hook(state, bucket):
    """A planted fault for ``dp_bounds.py``: DDP's all-reduce without the
    division by the world size (gradients summed, not averaged)."""
    import torch.distributed as dist

    fut = dist.all_reduce(bucket.buffer(), async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


def dp_plant(t, fault):
    """``fault`` planted into trainer ``t``'s current DP state."""
    if fault == "no_allreduce":
        t.state.replica = None
    elif fault == "sum":
        t.state.replica.register_comm_hook(None, dp_sum_hook)


def dp_batches(torch, np, t, n, b, seed, detection=False):
    """``n`` global batches of ``b`` synthetic images on the card, the frozen
    teacher's outputs for them computed once on the global batch (the same on
    every rank)."""
    from qat_vit_tpu_torch.parallel.dryrun import to_device

    rng = np.random.default_rng(seed)
    images = t.data["train_images"]
    out = []
    for _ in range(n):
        sel = rng.choice(len(images), b, replace=False)
        batch = {"image": images[sel]}
        if detection:
            lg, bx, ob = t._teacher_forward(batch["image"])
            batch.update(t_logits=lg, t_boxes=bx, t_obj=ob)
            batch = to_device(batch, "cuda")
            batch["query_embeds"] = t._queries_for(b).contiguous()
        else:
            batch["label"] = t.data["train_labels"][sel].astype(np.int64)
            batch["teacher_logits"] = t._teacher_forward(batch["image"])
            batch = to_device(batch, "cuda")
        out.append(batch)
    return out


def dp_run_steps(torch, t, steps, batches, info, limits, fault=None, loss_key="train_loss"):
    """Each ``(name, step_fn)`` of ``steps`` on this rank's shard of its
    global batch, against one process on the whole batch from the same
    state (``step_against_one_process``); returns the readings and the
    limits each missed."""
    from qat_vit_tpu_torch.parallel.dryrun import shard_of, step_against_one_process

    rows, bad = [], []
    for (name, fn), whole in zip(steps, batches):
        if name == "qat" and not t.qat_enabled:
            t.enable_qat()
            dp_plant(t, fault)
        r = step_against_one_process(t.state, fn, shard_of(whole, info.rank, info.world_size),
                                     whole, t.loss_hp, loss_key=loss_key)
        r["step"] = name
        rows.append(r)
        held = {k: v for k, v in limits.items()
                if not (k == "loss_rel" and name != "float") and not (k == "obs_rel"
                                                                       and name != "qat")}
        bad += [f"{name} step {len(rows)} {k} {r[k]:.3e} > {v}" for k, v in held.items()
                if r[k] > v]
        if not r["ranks_identical"]:
            bad.append(f"{name} step {len(rows)}: the ranks' parameters or observers differ")
    return rows, bad


def dp_timed(torch, fn, t, shard, n):
    """ms per DP step over ``n`` steps back to back (host clock from a
    barrier to a synchronize): the two ranks in lockstep."""
    from qat_vit_tpu_torch.parallel import barrier

    barrier("timed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(t.state, shard, t.loss_hp)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def dp_vit(torch, np, fa, fat, info, seed, fault=None, full=True):
    """ViT-S/16 from a bf16 ViT-B/16 at DP_B images per rank: 3 float, 3
    observing QAT and 1 frozen QAT DP steps against one process on the
    global batch; with ``full`` also the kernels' launches and one profiled
    QAT step on this rank, and the DP steps' times."""
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.models.registry import create_student
    from qat_vit_tpu_torch.parallel.dryrun import shard_of

    world = info.world_size
    data = synthetic_cifar10(n_train=4 * DP_B * world, n_test=64, seed=seed)
    student, teacher = vit_models(torch, seed)
    t = vit_trainer(torch, data, student, teacher, DP_B, seed=seed, observer_interval=2)
    if t.student_qat_cfg.quant.activation.axis_name != "data" or t.state.replica is None:
        fail(f"rank {info.rank}: the trainer is not data-parallel: {t.student_qat_cfg.quant}")
    dp_plant(t, fault)
    floats = [("float", t.train_step_float)] * DP_FLOAT_STEPS
    qats = [("qat", t.train_step_qat)] * DP_QAT_STEPS + [("frozen", t.train_step_qat_frozen)]
    batches = dp_batches(torch, np, t, len(floats) + len(qats), DP_B * world, seed + 100)
    shard = shard_of(batches[0], info.rank, world)
    rows, bad = dp_run_steps(torch, t, floats, batches, info, DP_LIMITS, fault)
    if full:
        float_ms = dp_timed(torch, t.train_step_float, t, shard, DP_TIMED_STEPS)
    more, more_bad = dp_run_steps(torch, t, qats, batches[len(floats):], info, DP_LIMITS, fault)
    out = {"rows": rows + more, "bad": bad + more_bad}
    if not full:
        return out
    bad = out["bad"]
    fa.attention_fwd.launches = fat.attention_bwd.launches = 0
    qat_ms = dp_timed(torch, t.train_step_qat, t, shard, DP_TIMED_STEPS)
    frozen_ms = dp_timed(torch, t.train_step_qat_frozen, t, shard, DP_TIMED_STEPS)
    launches = (fa.attention_fwd.launches, fat.attention_bwd.launches)
    groups, busy, wall, n_kernels, by_group = device_breakdown(
        torch, lambda: t.train_step_qat(t.state, shard, t.loss_hp))
    depth = t.student_qat_cfg.depth
    out.update(qat_ms=qat_ms, frozen_ms=frozen_ms, float_ms=float_ms, launches=launches,
               profile={"kernel A": by_group["K3 / kernel A"],
                        "kernel B rows": by_group["kernel B rows"],
                        "kernel B keys": by_group["kernel B keys"],
                        "busy_ms": busy, "wall_ms": wall, "kernels": n_kernels})
    if launches != (2 * DP_TIMED_STEPS * depth,) * 2:
        bad.append(f"the timed DP steps launched kernel A / B {launches}, expected "
                   f"{2 * DP_TIMED_STEPS * depth} each")
    if groups and [out["profile"][k] for k in ("kernel A", "kernel B rows", "kernel B keys")] \
            != [depth] * 3:
        bad.append(f"the profiled DP QAT step ran {out['profile']}, expected {depth} of each")
    if not groups:
        out["profile"] = None
    return out


def dp_detect(torch, np, la, info, seed, fault=None):
    """OWLv2-pruned at full width, depth DP_DET_DEPTH, DP_DET_B images per
    rank: one float and one QAT DP step against one process on the global
    batch; then one more QAT DP step, its K5a / K5b launches counted."""
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.parallel.dryrun import shard_of

    world = info.world_size
    data = synthetic_cifar10(n_train=8 * DP_DET_B * world, n_test=16, seed=seed)
    t = detect_trainer(torch, data, DP_DET_B, depth=DP_DET_DEPTH, seed=seed)
    dp_plant(t, fault)
    steps = [("float", t.train_step_float), ("qat", t.train_step_qat)]
    batches = dp_batches(torch, np, t, 3, DP_DET_B * world, seed + 200, detection=True)
    rows, bad = dp_run_steps(torch, t, steps, batches, info, DP_DET_LIMITS, fault)
    la.long_attention_qkv.launches = la.long_attention_bwd.launches = 0
    t.train_step_qat(t.state, shard_of(batches[2], info.rank, world), t.loss_hp)
    torch.cuda.synchronize()
    launches = (la.long_attention_qkv.launches, la.long_attention_bwd.launches)
    if launches != (DP_DET_DEPTH, 2 * DP_DET_DEPTH):
        bad.append(f"the detection DP step launched K5a / K5b {launches}, expected "
                   f"({DP_DET_DEPTH}, {2 * DP_DET_DEPTH})")
    return {"rows": rows, "bad": bad, "launches": launches}


def dp_identity(torch, np, info, seed):
    """A world of one (NCCL on the card): one QAT step through DDP against
    the step with no replica from the same state: identical bits."""
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.parallel.dryrun import restore, snapshot
    from qat_vit_tpu_torch.train.steps import TrainState

    data = synthetic_cifar10(n_train=2 * DP_B, n_test=16, seed=seed)
    student, teacher = vit_models(torch, seed)
    t = vit_trainer(torch, data, student, teacher, DP_B, seed=seed)
    t.enable_qat()
    (batch,) = dp_batches(torch, np, t, 1, DP_B, seed + 300)
    snap = snapshot(t.state)
    plain = TrainState(t.state.module, t.state.optimizer, t.state.step)
    want = t.train_step_qat(plain, batch, t.loss_hp)
    want_sd = {k: v.clone() for k, v in t.state.module.state_dict().items()}
    restore(t.state, snap)
    got = t.train_step_qat(t.state, batch, t.loss_hp)
    sd = t.state.module.state_dict()
    same = all(torch.equal(got[k], want[k]) for k in want) and all(
        torch.equal(sd[k], want_sd[k]) for k in sd)
    return {"identical": same, "replica": t.state.replica is not None,
            "loss": float(got["train_loss"])}


def dp_rank_main(job_path):
    """One rank of phase 11 (or of ``port_scripts/dp_bounds.py``): joins
    the world, runs the job's parts, writes ``{out}/rank{r}.json``."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from qat_vit_tpu_torch.ops import flash_attention as fa
    from qat_vit_tpu_torch.ops import flash_attention_train as fat
    from qat_vit_tpu_torch.ops import long_attention as la
    from qat_vit_tpu_torch.parallel import barrier, cleanup_distributed, setup_distributed
    from qat_vit_tpu_torch.quant import observers

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info, dev = setup_distributed("cuda", timeout_s=DP_TIMEOUT_S)
    fault = job.get("fault")
    if fault == "no_obs_reduce":
        observers.all_reduce_minmax = lambda lo, hi: (lo, hi)
    out = {"rank": info.rank, "world": info.world_size, "backend": dist.get_backend(),
           "device": str(dev)}
    try:
        for seed in job.get("seeds", [SEED]):
            res = {}
            if "identity" in job["parts"]:
                res["identity"] = dp_identity(torch, np, info, seed)
            if "vit" in job["parts"]:
                res["vit"] = dp_vit(torch, np, fa, fat, info, seed, fault,
                                    full=job.get("full", True))
            if "detect" in job["parts"]:
                res["detect"] = dp_detect(torch, np, la, info, seed, fault)
            out[str(seed)] = res
            gc.collect()
            torch.cuda.empty_cache()
        barrier("dp_end")
    finally:
        cleanup_distributed()
    with open(os.path.join(job["out"], f"rank{info.rank}.json"), "w") as f:
        json.dump(out, f)


def dp_launch(job, n, out_dir, timeout=DP_TIMEOUT_S, env=None):
    """Run ``job`` on ``n`` ranks of this script (``env`` over this
    process's environment); each rank's results and the seconds taken."""
    from qat_vit_tpu_torch.parallel.dryrun import launch

    os.makedirs(out_dir, exist_ok=True)
    job = dict(job, out=out_dir)
    path = os.path.join(out_dir, "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    t0 = time.perf_counter()
    launch([os.path.abspath(__file__), DP_CHILD, path], n, out_dir, timeout_s=timeout, env=env)
    secs = time.perf_counter() - t0
    results = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, secs


def _fmt_row(r):
    return (f"{r['step']}: loss {r['loss']:.5f}, loss rel {r['loss_rel']:.3e}, grad norm rel "
            f"{r['grad_norm_rel']:.3e}, params rel L2 {r['params_rel_l2']:.3e}, observers rel "
            f"{r['obs_rel']:.3e}, ranks identical {r['ranks_identical']}")


def torchrun_cli(root, args, log, n, timeout=900):
    """``python -m torch.distributed.run --standalone --nproc_per_node n -m
    qat_vit_tpu_torch.train.trainer ARGS`` from the checkout, its output into
    ``log``; fails unless it exits 0."""
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", "-m", "qat_vit_tpu_torch.train.trainer", *args]
    with open(log, "w") as f:
        rc = subprocess.run(cmd, cwd=root, stdout=f, stderr=subprocess.STDOUT,
                            timeout=timeout).returncode
    if rc != 0:
        with open(log) as f:
            print("".join(f.readlines()[-60:]), file=sys.stderr, flush=True)
        fail(f"torchrun of the training CLI on {n} ranks exited {rc}")
    return time.perf_counter() - t0


def phase_data_parallel(torch, np, fs, fa):
    """Data parallelism on the card: the dry run; two ranks' ViT-S/16 and
    detection DP steps against one process; a world of one on NCCL; the
    training CLI under torchrun on two ranks and its export through a
    predictor with a replica per device."""
    import re
    import shutil
    import tempfile

    from qat_vit_tpu_torch.parallel import make_mesh
    from qat_vit_tpu_torch.parallel.dryrun import dryrun_multichip
    from qat_vit_tpu_torch.serve.predictor import Int8Predictor
    from qat_vit_tpu_torch.utils.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    card = card_line()
    n_cards = torch.cuda.device_count()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        # (a) the package's dry run (micro models)
        dryrun_multichip(DP_WORLD, "cuda", timeout_s=DP_TIMEOUT_S)

        # (b) ViT-S/16 and detection on two ranks sharing the card (gloo); on
        # NCCL too when there are two cards
        layouts = [("gloo", {"CUDA_VISIBLE_DEVICES": "0"})]
        if n_cards >= 2:
            layouts.append(("nccl", {}))
        for backend, env in layouts:
            results, secs = dp_launch({"parts": ["vit", "detect"]}, DP_WORLD,
                                      os.path.join(tmp, backend), env=env)
            bad = []
            for res in results:
                if res["backend"] != backend:
                    bad.append(f"rank {res['rank']} ran on {res['backend']}")
                r = res[str(SEED)]
                for part in ("vit", "detect"):
                    for row in r[part]["rows"]:
                        print(f"phase 11 rank {res['rank']}/{DP_WORLD} ({backend}) {part} DP "
                              f"step vs one process on the global batch: " + _fmt_row(row),
                              flush=True)
                    bad += [f"rank {res['rank']} {part}: {b}" for b in r[part]["bad"]]
                v = r["vit"]
                print(f"phase 11 rank {res['rank']}/{DP_WORLD} ({backend}, two ranks sharing "
                      f"one card: a record, not a scaling figure) ViT-S/16 at {DP_B} per rank: "
                      f"DP step ms float {v['float_ms']:.2f}, observing QAT {v['qat_ms']:.2f}, "
                      f"frozen QAT {v['frozen_ms']:.2f}; global img/s float "
                      f"{DP_B * DP_WORLD / v['float_ms'] * 1e3:.1f}, observing QAT "
                      f"{DP_B * DP_WORLD / v['qat_ms'] * 1e3:.1f}; kernel A / B launches over "
                      f"{2 * DP_TIMED_STEPS} timed QAT steps {v['launches']}; one profiled QAT "
                      f"DP step {v['profile']}; detection DP step K5a / K5b launches "
                      f"{r['detect']['launches']} on {card}", flush=True)
            if bad:
                fail("phase 11 DP steps: " + "; ".join(bad))
            print(f"phase 11 {DP_WORLD} ranks on {backend} took {secs:.1f} s", flush=True)
        if n_cards < 2:
            print(f"phase 11 NCCL with one card per rank: not run ({n_cards} card)", flush=True)

        # (c) a world of one on NCCL: identical to no process group
        results, secs = dp_launch({"parts": ["identity"]}, 1, os.path.join(tmp, "one"))
        r = results[0]
        ident = r[str(SEED)]["identity"]
        print(f"phase 11 a world of one on {r['backend']}: one QAT step through DDP at batch "
              f"{DP_B} identical to the step without a replica {ident['identical']} (loss "
              f"{ident['loss']:.6f}; {secs:.1f} s)", flush=True)
        if r["backend"] != "nccl" or not ident["identical"] or not ident["replica"]:
            fail(f"the world of one: {r}")

        # (d) the training CLI under torchrun on two ranks sharing the card
        out, db = os.path.join(tmp, "cli"), os.path.join(tmp, "cli.db")
        log = os.path.join(tmp, "torchrun.log")
        secs = torchrun_cli(root, ENTRY_ARGS + ["--output-dir", out, "--mlflow-uri",
                                                f"sqlite:///{db}", "--data-dir",
                                                os.path.join(tmp, "no_cifar")], log, DP_WORLD)
        with open(log) as f:
            text = f.read()
        wrote = re.findall(r"rank (\d+) INFO \S+: wrote (\S+)", text)
        epochs = re.findall(r"rank (\d+)/(\d+) epoch (\d+) metrics (\{.*?\}) img/s ([\d.]+)", text)
        by_epoch = {}
        for rank, world, epoch, metrics, ips in epochs:
            by_epoch.setdefault(int(epoch), {})[int(rank)] = (json.loads(metrics), float(ips))
        written = {os.path.basename(p) for _, p in wrote}
        writers = {int(r) for r, _ in wrote}
        missing = [f for f in ENTRY_FILES if not os.path.isfile(os.path.join(out, f))]
        same = all(len(v) == DP_WORLD and len({json.dumps(m, sort_keys=True) for m, _ in
                                                v.values()}) == 1 for v in by_epoch.values())
        print(f"phase 11 the training CLI under torchrun, {DP_WORLD} ranks sharing the card "
              f"(gloo), {' '.join(ENTRY_ARGS)} per rank: exit 0 in {secs:.1f} s; files written "
              f"by ranks {sorted(writers)}: {sorted(written)}; epoch metrics by rank "
              + "; ".join(f"epoch {e}: " + ", ".join(f"rank {k} {m} ({ips:.1f} img/s)"
                                                      for k, (m, ips) in sorted(v.items()))
                          for e, v in sorted(by_epoch.items()))
              + f"; identical on the ranks {same}", flush=True)
        if (missing or writers != {0} or not set(ENTRY_FILES) <= written
                or sorted(by_epoch) != [0, 1] or not same):
            fail(f"the torchrun CLI: missing {missing}, writers {writers}, written {written}, "
                 f"epochs {sorted(by_epoch)}, identical {same}")

        # (e) its export through one device and through a replica per device
        qcfg = cli_student_cfg(torch)
        export = load_checkpoint(os.path.join(out, "best_converted.msgpack"))
        images = np.random.default_rng(SEED).integers(0, 256, (SERVE_B, 32, 32, 3), np.uint8)
        one = Int8Predictor.from_checkpoint(os.path.join(out, "best_converted.msgpack"), qcfg,
                                            device="cuda", batch_size=SERVE_B).logits(images)
        mesh = make_mesh(devices=["cuda:0", "cuda:0"])
        fa.fused_attention_qkv.launches = 0
        dp = Int8Predictor.from_checkpoint(os.path.join(out, "best_converted.msgpack"), qcfg,
                                           mesh=mesh, batch_size=SERVE_B).logits(images)
        torch.cuda.synchronize()
        k3 = fa.fused_attention_qkv.launches
        print(f"phase 11 the torchrun CLI's export through Int8Predictor(mesh=make_mesh("
              f"devices=[cuda:0, cuda:0])) at batch {SERVE_B}: logits {dp.shape}, finite "
              f"{np.isfinite(dp).all()}, identical to one device {np.array_equal(dp, one)}, "
              f"K3 launches {k3} (two replicas of {qcfg.depth} blocks)", flush=True)
        if (dp.shape != (SERVE_B, 10) or not np.isfinite(dp).all()
                or not np.array_equal(dp, one) or k3 != 2 * qcfg.depth or not export):
            fail("the mesh predictor's logits are not one device's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)


# phase 12: the TPE search, evaluation and the model tail. The search at full
# width (ViT-S/16 at 224 px from a random-init ViT-B/16): trials, epochs,
# batch, eval batch, train and eval batches per epoch; 3 epochs, so that the
# search space's qat_start_epoch in [0, 1] gives float and QAT epochs
SEARCH_TRIALS, SEARCH_EPOCHS, SEARCH_B, SEARCH_LIMIT = 3, 3, 64, 2
# memory allocated after the last trial against after the first (a freed trial)
SEARCH_MEM_REL = 0.05
# the detection search: OWLv2-pruned at 768 px, trials, epochs, batch, eval batch
DET_SEARCH_TRIALS, DET_SEARCH_EPOCHS, DET_SEARCH_B, DET_SEARCH_EVAL_B = 2, 2, 4, 8
# the evaluator on phase 10's artifacts (the CLI's student): batches of
# EVAL_B test images
EVAL_MODEL, EVAL_BATCHES, EVAL_B = "vit_small_patch16_224_student", 4, 512
# the remat steps' batch, and the steady steps timed after the compared one
REMAT_B, REMAT_TIMED = 256, 3
# get_model_complexity of the entries phase 12 prints: the JAX package's
# values, which tests/test_torch_port_tail.py holds the port to on the CPU
COMPLEXITY = {
    "vit_small_patch16_224_student": {"params": 21669514, "gflops": 4.7},
    "vit_base_patch16_224_teacher": {"params": 85806346, "gflops": 17.6},
    "vit_tiny_patch16_224": {"params": 5526346, "gflops": 1.2},
    "owlv2_base_teacher": {"params": 88421386, "gflops": 1093.97},
    "owlv2_student_pruned": {"params": 45647434, "gflops": 314.1},
}
P12_ONLY = "--phase-12"  # the build, phase 10's CLI run and phase 12 alone, printing no result
P12_CHILD = "--phase-12-child"  # phase 12 on given artifacts, in a child process


def run_module(root, module, args, log, timeout=600):
    """``python -m MODULE ARGS`` in a child process from the checkout, its
    output into ``log``; fails unless it exits 0. Returns (seconds, output)."""
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, "-m", module, *args], cwd=root, stdout=f,
                            stderr=subprocess.STDOUT, timeout=timeout).returncode
    with open(log) as f:
        text = f.read()
    if rc != 0:
        print(text[-6000:], file=sys.stderr, flush=True)
        fail(f"python -m {module} exited {rc}: {args}")
    return time.perf_counter() - t0, text


def search_counters(torch, driver, fa, fat, la, trainer_cls):
    """A subclass of ``trainer_cls`` that records per trial: the kernels'
    launches per epoch, img/s, the teacher's forwards and the rows they
    filled; and a ``create_study`` whose trials record the memory allocated
    once each trial's trainer is gone. Returns (class, create_study, log)."""
    import gc

    log = {"trials": [], "mem": []}

    class Recorded(trainer_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            log["trials"].append({"seed": kw.get("seed"), "epochs": [], "filled": [],
                                  "teacher_calls": 0, "t0": time.perf_counter(),
                                  "shared_teacher": kw.get("teacher_params") is not None})

        def _teacher_forward(self, *a, **kw):
            log["trials"][-1]["teacher_calls"] += 1
            return super()._teacher_forward(*a, **kw)

        def _teacher_logits_for(self, batch):
            idx = batch["index"]
            log["trials"][-1]["filled"] += idx[~self._teacher_mask[idx]].tolist()
            return super()._teacher_logits_for(batch)

        def train_epoch(self, epoch, limit_batches=0):
            before = (fa.attention_fwd.launches, fat.attention_bwd.launches,
                      la.long_attention_qkv.launches, la.long_attention_bwd.launches)
            tm = super().train_epoch(epoch, limit_batches)
            torch.cuda.synchronize()
            after = (fa.attention_fwd.launches, fat.attention_bwd.launches,
                     la.long_attention_qkv.launches, la.long_attention_bwd.launches)
            log["trials"][-1]["epochs"].append(
                (epoch, self.qat_enabled, *(a - b for a, b in zip(after, before)),
                 round(tm["imgs_per_sec"], 1)))
            return tm

    plain_create = driver._tpe.create_study

    def create_study(*a, **kw):
        study = plain_create(*a, **kw)
        plain_optimize = study.optimize

        def optimize(objective, n_trials, catch=()):
            def measured(trial):
                try:
                    return objective(trial)
                finally:
                    gc.collect()
                    torch.cuda.synchronize()
                    log["mem"].append(torch.cuda.memory_allocated())
                    log["trials"][-1]["seconds"] = time.perf_counter() - log["trials"][-1]["t0"]
            return plain_optimize(measured, n_trials, catch)

        study.optimize = optimize
        return study

    return Recorded, create_study, log


def run_search(torch, driver, cfg, data, fa, fat, la, detection=False):
    """``run_optuna_search`` on the card with the recording trainer; the
    study, the tracked runs and the log."""
    from qat_vit_tpu_torch.tracking import SqliteTracker
    from qat_vit_tpu_torch.train import detect_trainer as dt

    owner, name = (dt, "DetectKDTrainer") if detection else (driver, "KDQATTrainer")
    plain_cls, plain_create = getattr(owner, name), driver._tpe.create_study
    cls, create_study, log = search_counters(torch, driver, fa, fat, la, plain_cls)
    setattr(owner, name, cls)
    driver._tpe.create_study = create_study
    try:
        t0 = time.perf_counter()
        res = driver.run_optuna_search(cfg, data=data, device=torch.device("cuda"))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        setattr(owner, name, plain_cls)
        driver._tpe.create_study = plain_create
    store = SqliteTracker(cfg.mlflow_uri, cfg.experiment, create=False)
    runs = {r["name"]: r for r in store.runs()}
    return res, runs, store, log, secs


def phase_search(torch, fa, fat, la, tmp, data, card):
    """(a) the classification search at full width, (b) its CLI in a child
    process, (c) the detection search."""
    import dataclasses

    from qat_vit_tpu_torch.search import driver
    from qat_vit_tpu_torch.train.config import load_hparams

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = driver.SearchConfig(
        trials=SEARCH_TRIALS, epochs=SEARCH_EPOCHS, batch_size=SEARCH_B, eval_batch_size=SEARCH_B,
        limit_train_batches=SEARCH_LIMIT, limit_eval_batches=SEARCH_LIMIT, seed=SEED,
        output_dir=os.path.join(tmp, "search"), mlflow_uri=f"sqlite:///{tmp}/search.db")
    if driver.HAS_OPTUNA:
        fail("optuna is installed on this machine: the phase runs the in-repo TPE")
    res, runs, store, log, secs = run_search(torch, driver, cfg, data, fa, fat, la)
    study, trials, mem = res["study"], log["trials"], log["mem"]
    depth = 12
    print(f"phase 12 search: {SEARCH_TRIALS} trials x {SEARCH_EPOCHS} epochs of {SEARCH_LIMIT} "
          f"steps at batch {SEARCH_B} (ViT-S/16 from a random-init ViT-B/16, in-repo TPE) in "
          f"{secs:.1f} s on {card}", flush=True)
    bad = []
    for k, (t, rec) in enumerate(zip(study.trials, trials)):
        run = runs.get(f"trial_{k:04d}", {})
        tags = dict(sqlite_tags(store, run.get("run_id")))
        print(f"phase 12 trial {k}: seed {rec['seed']}, params {t.params}, state {t.state}, "
              f"run {run.get('status')} / {tags.get('optuna_state')}, value {t.value}; "
              f"{rec['seconds']:.2f} s; epochs (epoch, QAT, kernel A, kernel B, K5a, K5b "
              f"launches, img/s) {rec['epochs']}; teacher forwards {rec['teacher_calls']} "
              f"filling {len(rec['filled'])} rows; memory allocated after the trial "
              f"{mem[k] / 2 ** 20:.1f} MiB", flush=True)
        want = SEARCH_LIMIT * depth
        if (t.state != "COMPLETE" or run.get("status") != "FINISHED"
                or tags.get("optuna_state") != "COMPLETE" or rec["seed"] != SEED + k
                or any(e[2] != want or e[3] != want for e in rec["epochs"])
                or len(rec["epochs"]) != SEARCH_EPOCHS or rec["shared_teacher"] != (k > 0)):
            bad.append(k)
    filled0 = set(trials[0]["filled"])
    refilled = [sorted(filled0 & set(t["filled"]))[:5] for t in trials[1:]]
    kinds = {e[1] for t in trials for e in t["epochs"]}
    summary = runs.get("optuna_best_summary", {})
    back = load_hparams(res["best_params_path"])
    read_ok = all(back[driver_key(k)] == v for k, v in res["best_params"].items())
    growth = (mem[-1] - mem[0]) / mem[0]
    print(f"phase 12 search: rows trial 0 filled that later trials filled again {refilled}; "
          f"float and QAT epochs both ran {kinds == {False, True}}; summary run "
          f"{summary.get('status')}; best_params.yaml read back by load_hparams "
          f"{read_ok}; memory allocated after trial 0 / {SEARCH_TRIALS - 1}: "
          f"{mem[0] / 2 ** 20:.1f} / {mem[-1] / 2 ** 20:.1f} MiB ({100 * growth:+.2f}%)",
          flush=True)
    if (bad or any(refilled) or not filled0 or kinds != {False, True}
            or summary.get("status") != "FINISHED" or not read_ok
            or abs(growth) > SEARCH_MEM_REL):
        fail(f"the search: trials {bad}, refilled {refilled}, epochs {kinds}, summary "
             f"{summary}, read back {read_ok}, memory {mem}")

    # (b) the CLI in a child process: 1 trial of 2 epochs
    cli_secs, text = run_module(root, "qat_vit_tpu_torch.search.driver", [
        "--trials", "1", "--epochs", "2", "--batch-size", str(SEARCH_B), "--eval-batch-size",
        str(SEARCH_B), "--limit-train-batches", str(SEARCH_LIMIT), "--limit-eval-batches",
        str(SEARCH_LIMIT), "--output-dir", os.path.join(tmp, "search_cli"), "--mlflow-uri",
        f"sqlite:///{tmp}/search_cli.db", "--data-dir", os.path.join(tmp, "data")],
        os.path.join(tmp, "search_cli.log"))
    cli_best = os.path.join(tmp, "search_cli", "best_params.yaml")
    print(f"phase 12 the search CLI (python -m qat_vit_tpu_torch.search.driver, 1 trial of 2 "
          f"epochs) in a child process: exit 0 in {cli_secs:.1f} s; best_params.yaml "
          f"{load_hparams(cli_best)['kd_temperature']!r} kd_temperature", flush=True)

    # (c) the detection search: OWLv2-pruned at 768 px from a bf16 OWLv2-base
    dcfg = dataclasses.replace(
        cfg, task="detection", image_size=768, trials=DET_SEARCH_TRIALS, epochs=DET_SEARCH_EPOCHS,
        batch_size=DET_SEARCH_B, eval_batch_size=DET_SEARCH_EVAL_B, limit_train_batches=1,
        limit_eval_batches=1, output_dir=os.path.join(tmp, "det_search"),
        mlflow_uri=f"sqlite:///{tmp}/det_search.db")
    dres, druns, dstore, dlog, dsecs = run_search(torch, driver, dcfg, data, fa, fat, la,
                                                  detection=True)
    keys = set()
    for k in range(DET_SEARCH_TRIALS):
        run = druns.get(f"trial_{k:04d}", {})
        keys |= {m["key"] for m in dstore.metrics(run["run_id"])} if run else set()
    det_states = [t.state for t in dres["study"].trials]
    det_epochs = [t["epochs"] for t in dlog["trials"]]
    print(f"phase 12 detection search: {DET_SEARCH_TRIALS} trials x {DET_SEARCH_EPOCHS} epochs "
          f"of 1 step at batch {DET_SEARCH_B} (OWLv2-pruned at 768 px, 2,305 tokens) in "
          f"{dsecs:.1f} s: states {det_states}, epochs (epoch, QAT, kernel A, kernel B, K5a, "
          f"K5b launches, img/s) {det_epochs}, seconds per trial "
          f"{[round(t['seconds'], 2) for t in dlog['trials']]}, metrics {sorted(keys)}",
          flush=True)
    if (det_states != ["COMPLETE"] * DET_SEARCH_TRIALS
            or not {"val_agreement_limited", "train_loss_box"} <= keys
            or any(e[4] == 0 or e[5] == 0 for t in det_epochs for e in t)):
        fail(f"the detection search: {det_states}, {det_epochs}, {sorted(keys)}")


def driver_key(key):
    """The trainer's name of a ``best_params.yaml`` key (``kd_temp``)."""
    return {"kd_temp": "kd_temperature"}.get(key, key)


def sqlite_tags(store, run_id):
    import sqlite3

    if run_id is None:
        return []
    with sqlite3.connect(store.path) as c:
        return c.execute("SELECT key, value FROM tags WHERE run_uuid=?", (run_id,)).fetchall()


def phase_evaluation(torch, np, fs, fa, tmp, artifacts, qat_ckpt, teacher_ckpt, card):
    """The evaluator on the fake-quant student ``qat_ckpt`` (phase 12's
    remat QAT steps: every observer finite) and phase 10's int8 export:
    three CLI runs in this process (their loops timed), one in a child
    process, the preset against ``Int8Predictor.from_checkpoint``, one
    profiled preset batch, the comparator."""
    import contextlib
    import io

    from qat_vit_tpu_torch.data.cifar10 import load_cifar10
    from qat_vit_tpu_torch.data.pipeline import preprocess_fn
    from qat_vit_tpu_torch.evaluation import comparator, evaluator
    from qat_vit_tpu_torch.models.jax_params import export_from_numpy
    from qat_vit_tpu_torch.models.registry import create_architecture
    from qat_vit_tpu_torch.models.vit import count_fake_quant_sites
    from qat_vit_tpu_torch.serve.int8_vit import export_to_device, make_int8_forward
    from qat_vit_tpu_torch.serve.int8_vit import serving_preset
    from qat_vit_tpu_torch.serve.predictor import Int8Predictor
    from qat_vit_tpu_torch.utils.checkpoint import load_checkpoint, load_metadata

    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    data_dir = os.path.join(tmp, "data")
    conv_ckpt = os.path.join(artifacts, "best_converted.msgpack")
    common = ["--data-dir", data_dir, "--batch-size", str(EVAL_B), "--limit-batches",
              str(EVAL_BATCHES)]
    n_images = EVAL_BATCHES * EVAL_B
    loops = []
    plain_eval = evaluator.evaluate_model

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_eval(*a, **kw)
        loops.append(time.perf_counter() - t0)
        return out

    # every fake-quant site of the evaluated student holds finite statistics,
    # so every site fake-quantizes (an unobserved one passes values through)
    def leaves(tree):
        return [x for v in tree.values() for x in leaves(v)] if isinstance(tree, dict) else [tree]

    stats = [np.asarray(v) for v in leaves(load_checkpoint(qat_ckpt)["quant_stats"])]
    sites = count_fake_quant_sites(create_architecture(EVAL_MODEL, qat_wrapper=True).cfg)
    finite = all(np.isfinite(v).all() for v in stats)
    print(f"phase 12 the fake-quant student {os.path.basename(qat_ckpt)} "
          f"({load_metadata(qat_ckpt)}): {len(stats)} observer statistics for "
          f"{sum(sites.values())} fake-quant sites {sites}, all finite {finite}", flush=True)
    if not finite or len(stats) != 2 * sum(sites.values()):
        fail("the fake-quant student's observers are not all set")

    rows = []
    evaluator.evaluate_model = timed
    try:
        for label, extra in (("--qat-wrapper", ["--ckpt", qat_ckpt, "--qat-wrapper"]),
                             ("--int8 --serving exact", ["--ckpt", conv_ckpt, "--int8"]),
                             ("--int8 --serving preset", ["--ckpt", conv_ckpt, "--int8",
                                                          "--serving", "preset"])):
            for w in (fs.int8_dense, fs.int8_dense_gelu_q, fs.int8_dense_resid_ln_q,
                      fs.ln_quantize, fa.fused_attention_qkv):
                w.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                evaluator.main(extra + common, device=dev)
            wall = time.perf_counter() - t0
            line = buf.getvalue().strip().splitlines()[-1]
            k_launches = fs.int8_dense.launches + fa.fused_attention_qkv.launches
            rows.append((label, line, wall, loops[-1], k_launches))
    finally:
        evaluator.evaluate_model = plain_eval
    for label, line, wall, loop, k in rows:
        print(f"phase 12 evaluator {label} ({'phase 12' if 'qat' in label else 'phase 10'}'s "
              f"file), {EVAL_BATCHES} batches of "
              f"{EVAL_B}: {line}; {wall:.2f} s in all, the loop {loop:.3f} s = "
              f"{n_images / loop:.1f} img/s (host clock, the first batch's warm-up included) on "
              f"{card}; int8 kernel launches {k}", flush=True)
    if not all(r[1].startswith("top1_acc=") for r in rows) or rows[1][4] or not rows[2][4]:
        fail(f"the evaluator's runs: {rows}")

    # the preset against Int8Predictor.from_checkpoint over the same images
    data, _ = load_cifar10(data_dir)
    images, labels = data["test_images"][:n_images], data["test_labels"][:n_images]
    cfg = cli_student_cfg(torch)
    pred = Int8Predictor.from_checkpoint(conv_ckpt, cfg, device=dev, batch_size=EVAL_B)
    pred_correct = int((pred.predict(images) == labels).sum())
    got_correct = evaluator.evaluate_checkpoint(
        EVAL_MODEL, conv_ckpt, int8=True, serving="preset", data_dir=data_dir,
        batch_size=EVAL_B, limit_batches=EVAL_BATCHES, device=dev) * n_images
    print(f"phase 12 the preset's correct count {round(got_correct)}, "
          f"Int8Predictor.from_checkpoint's argmax over the same {n_images} images "
          f"{pred_correct} (preset {pred.options.get('fused')})", flush=True)
    if round(got_correct) != pred_correct:
        fail(f"the preset evaluation {got_correct} vs Int8Predictor {pred_correct}")

    # one profiled preset batch: the serving kernels by name
    ecfg = create_architecture(EVAL_MODEL, qat_wrapper=True).cfg
    qp = export_to_device(export_from_numpy(load_checkpoint(conv_ckpt)), dev)
    fwd = make_int8_forward(ecfg, **serving_preset(ecfg, dev))
    x = preprocess_fn(ecfg.image_size)(torch.from_numpy(images[:EVAL_B]).to(dev))
    fwd(qp, x)
    groups, busy, wall, n_k, counts = device_breakdown(torch, lambda: fwd(qp, x))
    need = ("K2a PLAIN", "K2b GELU_Q", "K2c RESID_LN_Q", "K2d LN", "K3 / kernel A")
    print(f"phase 12 one profiled preset batch of {EVAL_B}: kernels by group "
          f"{dict(counts)}; device ms {({g: round(v, 3) for g, v in groups.items()})}, busy "
          f"{busy:.3f} of {wall:.3f} ms", flush=True)
    if any(counts[g] == 0 for g in need) or counts[K7_GROUP]:
        fail(f"the profiled preset batch lacks {[g for g in need if counts[g] == 0]}")

    # (child) the evaluator as a module
    secs, text = run_module(root, "qat_vit_tpu_torch.evaluation.evaluator",
                            ["--ckpt", conv_ckpt, "--int8", "--serving", "preset"] + common,
                            os.path.join(tmp, "eval_cli.log"))
    child_line = [ln for ln in text.splitlines() if ln.startswith("top1_acc=")]
    print(f"phase 12 python -m qat_vit_tpu_torch.evaluation.evaluator --int8 --serving preset "
          f"in a child process: exit 0 in {secs:.1f} s, {child_line}", flush=True)
    if child_line != [rows[2][1]]:
        fail(f"the evaluator CLI printed {child_line}, in this process {rows[2][1]}")

    # the comparator, with a teacher row
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        comparator.main(["--teacher-ckpt", teacher_ckpt, "--qat-ckpt", qat_ckpt, "--quant-ckpt",
                         conv_ckpt] + common, device=dev)
    table = buf.getvalue().strip()
    print(f"phase 12 comparator (teacher: the search's random-init ViT-B/16 as a msgpack) in "
          f"{time.perf_counter() - t0:.1f} s:\n{table}", flush=True)
    if "ERROR" in table or len(table.splitlines()) != 5:
        fail("the comparator reported an error row")


def phase_remat(torch, np, fa, fat, data, card, qat_ckpt):
    """One float and then one QAT step of ViT-S/16 at batch 256 on a fresh
    trainer under remat none, none again (a second trainer right after the
    first: no leak between trainers, no run-to-run difference), dots and
    full: every leaf (loss, each gradient, parameter and observer) identical
    to none's. After the compared steps, on the same trainer: steady QAT
    steps timed and one profiled QAT step; steady float steps timed on a
    fresh trainer of the mode. Writes none's QAT student (params and the
    observers of its steps) to ``qat_ckpt`` for the evaluator."""
    from qat_vit_tpu_torch.models.jax_params import buffers_to_quant_stats, state_dict_to_params
    from qat_vit_tpu_torch.utils.checkpoint import save_checkpoint

    student, teacher = vit_models(torch)
    dev = torch.device("cuda")
    b_float, b_qat = train_batches(torch, np, data, REMAT_B, 2, dev, SEED + 31)

    def timed_steps(t, batch):
        times = []
        for _ in range(REMAT_TIMED):
            t0 = time.perf_counter()
            t.next_step_fn()(t.state, batch, t.loss_hp)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    results = {}
    for label in ("none", "none again", "dots", "full"):
        mode = label.split()[0]
        t = vit_trainer(torch, data, student, teacher, REMAT_B, remat=mode)
        rec = {}
        for phase, batch in (("float", b_float), ("qat", b_qat)):  # the compared steps
            if phase == "qat":
                t.enable_qat()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fa.attention_fwd.launches = fat.attention_bwd.launches = 0
            t0 = time.perf_counter()
            m = t.next_step_fn()(t.state, batch, t.loss_hp)
            torch.cuda.synchronize()
            rec[phase] = {
                "loss": m["train_loss"].clone(), "first_ms": (time.perf_counter() - t0) * 1e3,
                "peak": torch.cuda.max_memory_allocated() - base,
                "launches": (fa.attention_fwd.launches, fat.attention_bwd.launches),
                "grads": {k: p.grad.clone() for k, p in t.state.module.named_parameters()},
                "state": {k: v.clone() for k, v in t.state.module.state_dict().items()}}
        if label != "none again":
            # the state moves on from here; nothing is compared after it
            rec["qat"]["ms"] = timed_steps(t, b_qat)
            _, _, _, _, counts = device_breakdown(
                torch, lambda: t.next_step_fn()(t.state, b_qat, t.loss_hp))
            rec["profile"] = {g: counts[g] for g in ("K3 / kernel A", "kernel B rows",
                                                     "kernel B keys")}
            if label == "none":
                sd = t.state.module.state_dict()
                save_checkpoint(qat_ckpt, {"params": state_dict_to_params(sd),
                                           "quant_stats": buffers_to_quant_stats(sd)},
                                {"epoch": 0, "qat_enabled": True,
                                 "steps": f"1 float + {REMAT_TIMED + 2} QAT at batch {REMAT_B}"})
            del t
            t = vit_trainer(torch, data, student, teacher, REMAT_B, remat=mode)
            t.next_step_fn()(t.state, b_float, t.loss_hp)
            rec["float"]["ms"] = timed_steps(t, b_float)
        results[label] = rec
        del t
        torch.cuda.empty_cache()

    def differing(a, b):
        """Per phase, the leaves of ``a`` not identical to ``b``'s, each with
        its largest absolute difference."""
        out = {}
        for phase in ("float", "qat"):
            ra, rb = a[phase], b[phase]
            if ra["grads"].keys() != rb["grads"].keys() or ra["state"].keys() != rb["state"].keys():
                out[phase] = [("the leaves' names", float("nan"))]
                continue
            pairs = [("loss", ra["loss"], rb["loss"])]
            pairs += [(k + ".grad", ra["grads"][k], rb["grads"][k]) for k in rb["grads"]]
            pairs += [(k, ra["state"][k], rb["state"][k]) for k in rb["state"]]
            out[phase] = [(k, float((x.float() - y.float()).abs().max()))
                          for k, x, y in pairs if not torch.equal(x, y)]
        return out

    bad = []
    none = results["none"]
    n_leaves = {ph: 1 + len(none[ph]["grads"]) + len(none[ph]["state"]) for ph in ("float", "qat")}
    for label in ("none again", "dots", "full"):
        d = differing(results[label], none)
        print(f"phase 12 remat {label} at batch {REMAT_B} against none, leaf by leaf (loss, each "
              f"gradient, parameter and observer; {n_leaves['float']} float / {n_leaves['qat']} "
              f"QAT leaves): not identical float {d['float'][:5]} ({len(d['float'])}) / QAT "
              f"{d['qat'][:5]} ({len(d['qat'])}) (limit: identical)", flush=True)
        if d["float"] or d["qat"]:
            bad.append(f"{label} differs from none")
    want = {"none": 12, "dots": 12, "full": 24}
    for label in ("none", "dots", "full"):
        rec = results[label]
        print(f"phase 12 remat {label}: float step {rec['float']['ms']:.1f} ms (median of "
              f"{REMAT_TIMED}, a fresh trainer after one step; the compared first "
              f"{rec['float']['first_ms']:.1f}), peak memory {rec['float']['peak'] / 2 ** 30:.3f} "
              f"GiB; QAT step {rec['qat']['ms']:.1f} ms (median of {REMAT_TIMED} after the "
              f"compared first {rec['qat']['first_ms']:.1f}), peak "
              f"{rec['qat']['peak'] / 2 ** 30:.3f} GiB (the compared first step's, above the "
              f"memory allocated before it; ms by host clock between synchronizes) on {card}; "
              f"kernel A / B calls {rec['float']['launches']} / {rec['qat']['launches']}; the "
              f"profiled QAT step's kernels {rec['profile']}", flush=True)
        p = rec["profile"]
        if (p["K3 / kernel A"] != want[label] or p["kernel B rows"] != 12
                or p["kernel B keys"] != 12):
            bad.append(f"{label} profile {p}")
    if bad:
        fail(f"remat: {bad}")


def phase_tail(torch):
    """get_model_complexity of five entries against the JAX package's values,
    and the HF entries (random init on the meta device where transformers
    imports; a RuntimeError naming it where it does not)."""
    from qat_vit_tpu_torch.models import registry

    got = {n: registry.get_model_complexity(n) for n in COMPLEXITY}
    same = all({k: v for k, v in got[n].items() if k != "name"} == COMPLEXITY[n]
               for n in COMPLEXITY)
    print(f"phase 12 get_model_complexity {got}; equal to the values the CPU test holds {same}",
          flush=True)
    if not same:
        fail("get_model_complexity")
    try:
        import transformers  # noqa: F401

        have = True
    except ImportError:
        have = False
    for name, kw in (("owlv2_base_teacher_torch", {"pretrained": False}),
                     ("owlv2_student_pruned_torch", {})):
        try:
            with torch.device("meta"):
                model = registry.create_model(name, **kw)
            outcome = (f"built {type(model).__name__} with "
                       f"{sum(p.numel() for p in model.parameters())} parameters (meta device)")
            ok = have
        except RuntimeError as e:
            outcome = f"RuntimeError: {e}"
            ok = not have and "transformers" in str(e)
        print(f"phase 12 {name}: transformers importable {have}; {outcome}", flush=True)
        if not ok:
            fail(f"{name}: {outcome}")


def phase_search_eval_tail(torch, np, fs, fa, fat, la, artifacts):
    """Phase 12: the TPE search (classification and detection) with trial
    reuse, the evaluator and comparator on phase 10's artifacts, remat and
    the registry's tail."""
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.models.jax_params import state_dict_to_params
    from qat_vit_tpu_torch.models.registry import create_teacher
    from qat_vit_tpu_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    card = card_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p12_")
    try:
        data = synthetic_cifar10(n_train=4096, n_test=EVAL_BATCHES * EVAL_B, seed=SEED)
        os.makedirs(os.path.join(tmp, "data"))
        np.savez(os.path.join(tmp, "data", "cifar10.npz"), **data)
        phase_search(torch, fa, fat, la, tmp, data, card)
        # the comparator's teacher row: a random-init ViT-B/16 as a msgpack
        teacher = create_teacher("vit", generator=torch.Generator().manual_seed(SEED + 5))
        teacher_ckpt = os.path.join(tmp, "teacher.msgpack")
        save_checkpoint(teacher_ckpt,
                        {"params": state_dict_to_params(teacher.module.state_dict())})
        del teacher
        qat_ckpt = os.path.join(tmp, "qat_student.msgpack")
        phase_remat(torch, np, fa, fat, data, card, qat_ckpt)
        phase_evaluation(torch, np, fs, fa, tmp, artifacts, qat_ckpt, teacher_ckpt, card)
        phase_tail(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)


# phase 13: tensor parallelism. Two ranks share the card over gloo as a
# (data 1, model 2) rank grid (NCCL refuses two ranks on one GPU); with four
# cards or more, four ranks also run as (data 2, model 2) on NCCL, one card
# each. The ranks are this script (TP_CHILD), started as torchrun would.
TP_CHILD = "--tp-rank"
TP_ONLY = "--phase-13"  # the build and phase 13 alone, printing no result
TP_B, TP_TIMED_STEPS, TP_TIMEOUT_S = 32, 3, 600
# the training CLI under torchrun with --model-parallel 2: its epochs, steps,
# batch and eval batch (every layer's all-reduce goes through the host on gloo)
TP_CLI_ARGS = ["--epochs", "2", "--qat-start-epoch", "1", "--batch-size", "32",
               "--limit-train-batches", "2", "--limit-eval-batches", "1",
               "--eval-batch-size", "64", "--model-parallel", "2"]
# a TP step against one process's step from the same state on the global
# batch (parallel.dryrun.tp_step_against_one_process): the loss, the global
# gradient norm before the clip, the parameters after the step (gathered),
# every observer after the QAT step and the first block's qkv weight
# gradient (gathered, after the clip), held to limits between
# port_scripts/tp_bounds.py's readings over 4 seeds on the H100 (PERF.md §2;
# bf16 steps: the TP step rounds each rank's partial product to bf16 before
# the sum). Sound: the largest over both steps; faults (contiguous qkv split
# / proj unreduced / replicated gradients counted twice in the clip): the
# least over seeds of a run's largest:
# - loss 1.544e-3; 1.073e-2 / 1.181e-2 / 6.854e-4 (the clip moves no loss)
# - gradient norm 1.957e-3; 9.839e-2 / 1.635e-1 / 1.957e-1
# - parameters 1.360e-3; 6.807e-3 / 5.512e-3 / 1.099e-3 (AdamW's first
#   step is blind to the gradient's scale)
# - observers 3.571e-2; 3.448e-1 / 3.830e-1 / 1.829e-2
# - qkv gradient 2.206e-2; 1.151 / 6.255e-1 / 2.455e-1
# and the weight observers identical, the ranks identical after every
# step but proj unreduced's (apart after all 8). Every fault misses two
# limits or more.
TP_LIMITS = {"loss_rel": 5e-3, "grad_norm_rel": 2e-2, "params_rel_l2": 3e-3, "obs_rel": 1e-1,
             "qkv_grad_rel": 8e-2}
TP_METRICS = tuple(TP_LIMITS)


def tp_plant(fault):
    """``fault`` planted into this rank's tensor-parallel path (for
    ``port_scripts/tp_bounds.py``): ``qkv_contiguous`` (each rank takes a
    contiguous 1/k of qkv's rows), ``proj_unreduced`` (proj's partial
    product not summed over the model ranks), ``clip_twice`` (the clip's
    squared norm, replicated gradients included, summed over the model
    ranks)."""
    import torch

    from qat_vit_tpu_torch.parallel import dryrun, tensor
    from qat_vit_tpu_torch.train import steps

    if fault == "qkv_contiguous":
        def rows(cfg, k, m):
            lo, hi = tensor.head_bounds(cfg, k, m)
            n = 3 * (hi - lo) * cfg.head_dim
            return torch.arange(3 * lo * cfg.head_dim, 3 * lo * cfg.head_dim + n)
        tensor.qkv_rows = rows
    elif fault == "proj_unreduced":
        shard = dryrun.shard_module

        def planted(module, mesh):
            module = shard(module, mesh)
            for blk in module.blocks:
                blk.attn.proj.tp = None
            return module
        dryrun.shard_module = planted
    elif fault == "clip_twice":
        def clip(grads, max_norm, split=(), group=None):
            grads = list(grads) + list(split)
            sq = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))).square()
            norm = torch.sqrt(steps.all_reduce_sum(sq, group))
            factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
            torch._foreach_mul_(grads, factor)
            return norm
        steps.clip_by_global_norm_ = clip
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")


def tp_vit(torch, np, info, seed, model, timed=True):
    """ViT-S/16 at full width, depth 12, 224 px, from a bf16 ViT-B/16, in
    ``KDQATTrainer`` with ``model_parallel`` ``model``: one float and one
    observing QAT step of the trainer's steps on a global batch of TP_B, each
    split over the model axis against one process from the same whole state;
    returns the readings and the limits each missed."""
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.models.vit import VisionTransformer
    from qat_vit_tpu_torch.parallel.dryrun import tp_step_against_one_process

    data = synthetic_cifar10(n_train=4 * TP_B, n_test=16, seed=seed)
    student, teacher = vit_models(torch, seed)
    t = vit_trainer(torch, data, student, teacher, TP_B, seed=seed, model_parallel=model)
    mesh, fcfg, qcfg = t.mesh, t.student_float_cfg, t.student_qat_cfg
    bad = []
    if (mesh.model, mesh.data) != (model, info.world_size // model) or fcfg.attn_kernel \
            or qcfg.attn_kernel or qcfg.quant.weight.axis_name != "model":
        fail(f"rank {info.rank}: the trainer is not tensor-parallel: {mesh} / {qcfg}")
    whole = t.full_state_dict(t.student_float)
    batches = dp_batches(torch, np, t, 2, TP_B * mesh.data, seed + 500)
    rows = []
    for name, cfg, fn, batch in (("float", fcfg, t.train_step_float, batches[0]),
                                 ("qat", qcfg, t.train_step_qat, batches[1])):
        module = VisionTransformer(cfg)
        missing, _ = module.load_state_dict(whole, strict=False)
        if [k for k in missing if not k.endswith(("min_val", "max_val"))]:
            fail(f"rank {info.rank}: the whole student lacks {missing}")
        r = tp_step_against_one_process(module.to(t.device), mesh, fn, batch, t.loss_hp,
                                        lr=float(t.hp["lr"]), wd=float(t.hp["weight_decay"]),
                                        timed_steps=TP_TIMED_STEPS if timed else 0)
        r["step"] = name
        rows.append(r)
        for k, v in TP_LIMITS.items():
            if k == "obs_rel" and name != "qat":
                continue
            if r[k] > v:
                bad.append(f"{name} {k} {r[k]:.3e} > {v}")
        if not r["ranks_identical"] or not r["weight_obs_equal"]:
            bad.append(f"{name}: ranks identical {r['ranks_identical']}, weight observers "
                       f"identical {r['weight_obs_equal']}")
    return {"rows": rows, "bad": bad}


def tp_rank_main(job_path):
    """One rank of phase 13 (or of ``port_scripts/tp_bounds.py``): joins
    the world, runs ``tp_vit`` at the job's seeds, writes
    ``{out}/rank{r}.json``."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from qat_vit_tpu_torch.parallel import barrier, cleanup_distributed, setup_distributed

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp_plant(job.get("fault"))
    info, dev = setup_distributed("cuda", timeout_s=TP_TIMEOUT_S)
    out = {"rank": info.rank, "world": info.world_size, "backend": dist.get_backend(),
           "device": str(dev)}
    try:
        for seed in job.get("seeds", [SEED]):
            out[str(seed)] = tp_vit(torch, np, info, seed, job["model"],
                                    timed=job.get("timed", True))
            gc.collect()
            torch.cuda.empty_cache()
        barrier("tp_end")
    finally:
        cleanup_distributed()
    with open(os.path.join(job["out"], f"rank{info.rank}.json"), "w") as f:
        json.dump(out, f)


def tp_launch(job, n, out_dir, timeout=TP_TIMEOUT_S, env=None):
    """Run ``job`` on ``n`` ranks of this script (TP_CHILD); each rank's
    results and the seconds taken."""
    from qat_vit_tpu_torch.parallel.dryrun import launch

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "job.json")
    with open(path, "w") as f:
        json.dump(dict(job, out=out_dir), f)
    t0 = time.perf_counter()
    launch([os.path.abspath(__file__), TP_CHILD, path], n, out_dir, timeout_s=timeout, env=env)
    secs = time.perf_counter() - t0
    results = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, secs


def _tp_row(r):
    return (f"{r['step']}: loss {r['loss']:.5f}, " + ", ".join(f"{k} {r[k]:.3e}" for k in TP_METRICS)
            + f", weight observers identical {r['weight_obs_equal']}, ranks identical "
            f"{r['ranks_identical']}")


def phase_tensor_parallel(torch, np, fa):
    """Tensor parallelism on the card: two ranks' ViT-S/16 TP steps against
    one process (and four ranks' with four cards); the training CLI under
    torchrun with ``--model-parallel 2``, its checkpoint and resume file
    read in one process and its export served through ``Int8Predictor``."""
    import dataclasses
    import re

    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.models.jax_params import (
        params_to_state_dict,
        quant_stats_to_buffers,
    )
    from qat_vit_tpu_torch.models.vit import VisionTransformer
    from qat_vit_tpu_torch.serve.predictor import Int8Predictor
    from qat_vit_tpu_torch.utils.checkpoint import load_checkpoint, load_metadata

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    card = card_line()
    n_cards = torch.cuda.device_count()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        # (a) ViT-S/16 on a (1, 2) grid sharing the card (gloo); (d) on a (2,
        # 2) grid on NCCL with four cards
        layouts = [("gloo", 2, {"CUDA_VISIBLE_DEVICES": "0"})]
        if n_cards >= 4:
            layouts.append(("nccl", 4, {"CUDA_VISIBLE_DEVICES": "0,1,2,3"}))
        for backend, n, env in layouts:
            results, secs = tp_launch({"model": 2}, n, os.path.join(tmp, backend), env=env)
            bad = []
            for res in results:
                if res["backend"] != backend:
                    bad.append(f"rank {res['rank']} ran on {res['backend']}")
                r = res[str(SEED)]
                bad += [f"rank {res['rank']}: {b}" for b in r["bad"]]
                for row in r["rows"]:
                    print(f"phase 13 rank {res['rank']}/{n} ({backend}, data {n // 2} x model 2) "
                          f"ViT-S/16 TP step vs one process on the global batch of "
                          f"{TP_B * (n // 2)}: " + _tp_row(row), flush=True)
            r0 = results[0][str(SEED)]["rows"]
            shards = r0[0]["shards"]["params"]
            print(f"phase 13 ({backend}, {n} ranks) rank 0 holds qkv / proj / fc1 / fc2 "
                  f"{[shards[f'blocks.0.{k}'] for k in ('attn.qkv.weight', 'attn.proj.weight', 'mlp.fc1.weight', 'mlp.fc2.weight')]}"
                  f" and AdamW moments {r0[0]['shards']['moments']['blocks.0.attn.qkv.weight']}"
                  f" of qkv; ms per step over {TP_TIMED_STEPS} steps (host clock; the ranks "
                  f"{'share one card: a record, not a scaling figure' if backend == 'gloo' else 'one card each'}): "
                  + "; ".join(f"{row['step']} TP {row['ms']:.2f} vs one process "
                              f"{row['one_process_ms']:.2f}" for row in r0)
                  + f" at a global batch of {TP_B * (n // 2)} on {card}; {secs:.1f} s", flush=True)
            if bad:
                fail("phase 13 TP steps: " + "; ".join(bad))
        if n_cards < 4:
            print(f"phase 13 (d) data 2 x model 2 on NCCL, a card a rank: not run ({n_cards} "
                  f"card; it needs 4)", flush=True)

        # (c) the training CLI under torchrun, --model-parallel 2
        out, db = os.path.join(tmp, "cli"), os.path.join(tmp, "cli.db")
        log = os.path.join(tmp, "torchrun.log")
        secs = torchrun_cli(root, TP_CLI_ARGS + ["--output-dir", out, "--mlflow-uri",
                                                 f"sqlite:///{db}", "--data-dir",
                                                 os.path.join(tmp, "no_cifar")], log, 2)
        with open(log) as f:
            text = f.read()
        wrote = {int(r) for r, _ in re.findall(r"rank (\d+) INFO \S+: wrote (\S+)", text)}
        epochs = re.findall(r"rank (\d+)/(\d+) epoch (\d+) metrics (\{.*?\})", text)
        by_epoch = {}
        for rank, _, epoch, metrics in epochs:
            by_epoch.setdefault(int(epoch), {})[int(rank)] = metrics
        same = sorted(by_epoch) == [0, 1] and all(len(v) == 2 and len(set(v.values())) == 1
                                                   for v in by_epoch.values())
        missing = [f for f in ENTRY_FILES if not os.path.isfile(os.path.join(out, f))]
        # its checkpoint in one process, strictly: the whole student, QAT when
        # the best epoch was a QAT one (a float epoch may win the rule)
        qcfg = cli_student_cfg(torch)
        ckpt = load_checkpoint(os.path.join(out, "best_qat.msgpack"))
        qat_best = bool(load_metadata(os.path.join(out, "best_qat.msgpack"))["qat_enabled"])
        sd = params_to_state_dict(ckpt["params"])
        sd.update(quant_stats_to_buffers(ckpt["quant_stats"]))
        one = VisionTransformer(qcfg if qat_best else dataclasses.replace(
            qcfg, quant=None, qat_wrapper=False)).cuda()
        one.load_state_dict(sd, strict=True)
        images = np.random.default_rng(SEED).integers(0, 256, (64, 32, 32, 3), np.uint8)
        from qat_vit_tpu_torch.data.pipeline import preprocess_fn

        with torch.no_grad():
            fq_logits = one(preprocess_fn(224)(torch.from_numpy(images).cuda()))
        # its resume file in a one-process trainer: QAT at epoch 2, one more step
        data = synthetic_cifar10(n_train=4 * TP_B, n_test=16, seed=SEED)
        student, teacher = vit_models(torch, SEED)
        t = vit_trainer(torch, data, student, teacher, TP_B)
        epoch = t.load_resume_state(os.path.join(out, "resume_state.msgpack"))
        (batch,) = dp_batches(torch, np, t, 1, TP_B, SEED + 600)
        loss = float(t.train_step_qat(t.state, batch, t.loss_hp)["train_loss"])
        # its export through Int8Predictor (the preset: K2a-d and K3)
        fa.fused_attention_qkv.launches = 0
        logits = Int8Predictor.from_checkpoint(os.path.join(out, "best_converted.msgpack"), qcfg,
                                               device="cuda", batch_size=64).logits(images)
        torch.cuda.synchronize()
        k3 = fa.fused_attention_qkv.launches
        print(f"phase 13 the training CLI under torchrun, 2 ranks sharing the card (gloo), "
              f"{' '.join(TP_CLI_ARGS)}: exit 0 in {secs:.1f} s; files written by ranks "
              f"{sorted(wrote)}, missing {missing}; epoch metrics identical on the ranks {same}; "
              f"best_qat.msgpack (a {'QAT' if qat_best else 'float'} epoch's) loaded strictly "
              f"into one process's ViT-S/16, logits {tuple(fq_logits.shape)} finite "
              f"{bool(torch.isfinite(fq_logits).all())}; "
              f"resume_state.msgpack in a one-process trainer: epoch {epoch}, QAT "
              f"{t.qat_enabled}, one more QAT step loss {loss:.5f}; best_converted.msgpack "
              f"through Int8Predictor at batch 64: logits {logits.shape} finite "
              f"{np.isfinite(logits).all()}, K3 launches {k3}", flush=True)
        if (missing or wrote != {0} or not same or not torch.isfinite(fq_logits).all()
                or epoch != 2 or not t.qat_enabled or not np.isfinite(loss)
                or logits.shape != (64, 10) or not np.isfinite(logits).all()
                or k3 != qcfg.depth):
            fail("phase 13: the torchrun CLI with --model-parallel 2 or its files")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_12_in_child(torch, artifacts):
    """Phase 12 in a fresh process of this script, on phase 10's artifacts.
    Late in one process torch.profiler drops device events (phase 8's note;
    a profiled preset batch after phases 1-11 was seen to report 29 of its
    64 kernels), and phase 12 profiles a preset batch and remat steps."""
    torch.cuda.empty_cache()  # the child needs the memory the earlier phases cached
    rc = subprocess.run([sys.executable, os.path.abspath(__file__), P12_CHILD, artifacts],
                        cwd=os.path.dirname(os.path.abspath(__file__)), timeout=900).returncode
    if rc:
        fail(f"phase 12 (a child process) exited {rc}")


def phase_12_alone(torch):
    """``--phase-12``: phase 10's training CLI (2 epochs of 4 steps at batch
    256) for its artifacts, then phase 12 in its child process."""
    root = os.path.dirname(os.path.abspath(__file__))
    artifacts = tempfile.mkdtemp(prefix="chip_smoke_artifacts_")
    try:
        out = os.path.join(artifacts, "out")
        secs = run_cli(root, ENTRY_ARGS + ["--output-dir", out, "--mlflow-uri",
                                           f"sqlite:///{artifacts}/mlflow.db", "--data-dir",
                                           os.path.join(artifacts, "no_cifar")],
                       os.path.join(artifacts, "cli.log"))
        for f in ("best_converted.msgpack", "best_converted.msgpack.json"):
            shutil.copy(os.path.join(out, f), artifacts)
        print(f"phase 12 alone: the training CLI for phase 10's artifacts in {secs:.1f} s",
              flush=True)
        phase_12_in_child(torch, artifacts)
    finally:
        shutil.rmtree(artifacts, ignore_errors=True)


def cli_student_cfg(torch):
    """The CLI's QAT student config (ViT-S/16 at the trainer's defaults),
    which its export is served with."""
    import dataclasses

    from qat_vit_tpu_torch.models.registry import create_student
    from qat_vit_tpu_torch.train.config import load_hparams
    from qat_vit_tpu_torch.train.trainer import student_qconfig

    cfg = create_student("vit", generator=torch.Generator().manual_seed(SEED)).cfg
    return dataclasses.replace(cfg, quant=student_qconfig(load_hparams(None)), qat_wrapper=True,
                               dtype=torch.bfloat16, fast_math=True, fq_in_kernel=True)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA GPU",
              file=sys.stderr)
        sys.exit(2)
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "qat_vit_tpu_torch", "csrc")):
        fail(f"no qat_vit_tpu_torch/csrc beside {__file__}: run it from a checkout of the repository")
    sys.path.insert(0, root)
    from qat_vit_tpu_torch import _build
    from qat_vit_tpu_torch.ops import block_kernel as bk
    from qat_vit_tpu_torch.ops import flash_attention as fa
    from qat_vit_tpu_torch.ops import flash_attention_train as fat
    from qat_vit_tpu_torch.ops import fused_serve as fs
    from qat_vit_tpu_torch.ops import long_attention as la
    from qat_vit_tpu_torch.ops import pallas_gemm as pg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    if sys.argv[1:] == [F32_CHILD]:
        f32_attention_phase(torch, np, fa, fat)
        return
    if sys.argv[1:2] == [DP_CHILD]:
        dp_rank_main(sys.argv[2])
        return
    if sys.argv[1:2] == [P12_CHILD]:
        phase_search_eval_tail(torch, np, fs, fa, fat, la, sys.argv[2])
        return
    if sys.argv[1:2] == [TP_CHILD]:
        tp_rank_main(sys.argv[2])
        return

    # phase 1: environment and build
    card = card_line()
    print(card, flush=True)
    print(f"phase 1 torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    lib = _build.load()
    print(f"phase 1 kernels built in {lib.build_seconds:.1f} s: {lib.path.name}", flush=True)
    if sys.argv[1:] == [DP_ONLY]:
        phase_data_parallel(torch, np, fs, fa)
        print("chip_smoke: phase 11 alone (no result)", flush=True)
        return
    if sys.argv[1:] == [P12_ONLY]:
        phase_12_alone(torch)
        print("chip_smoke: phase 12 alone (no result)", flush=True)
        return
    if sys.argv[1:] == [TP_ONLY]:
        phase_tensor_parallel(torch, np, fa)
        print("chip_smoke: phase 13 alone (no result)", flush=True)
        return

    kernels = phase_kernels(torch, np, fs, fa, fat, la)
    launches, serve_ctx = phase_serving(torch, np, fs, fa)
    train_launches, ckpt_ctx = phase_training(torch, np, fs, fa, fat)
    launches.update(train_launches)
    for k in kernels:
        k["launches"] = launches[k["wrapper"]]
    det_kernels, det_ctx = phase_detection(torch, np, fs, la)
    kernels += det_kernels
    kernels += phase_detect_training(torch, np, fs, la)
    kernels += phase_serve_modes(torch, np, fs, fa, serve_ctx)
    kernels += phase_kernel_forms(torch, np, fs, fa, fat, la, det_ctx)
    phase_checkpoints(torch, np, fs, serve_ctx, ckpt_ctx)
    artifacts = tempfile.mkdtemp(prefix="chip_smoke_artifacts_")
    try:
        phase_entry_points(torch, np, fs, fa, fat, la, keep_dir=artifacts)
        phase_data_parallel(torch, np, fs, fa)
        phase_12_in_child(torch, artifacts)
        phase_tensor_parallel(torch, np, fa)
    finally:
        shutil.rmtree(artifacts, ignore_errors=True)

    sources = {fs.int8_dense: WGMMA_GEMM,
               fs.int8_dense_q8: WGMMA_GEMM,
               la.long_attention_q8: "qat_vit_tpu_torch/csrc/attention_long_q_mma.cu",
               fs.int8_dense_gelu_q: WGMMA_GEMM,
               fs.int8_dense_resid_ln_q: "qat_vit_tpu_torch/csrc/int8_gemm.cu",
               fs.ln_quantize: "qat_vit_tpu_torch/csrc/ln_quantize.cu",
               fa.fused_attention_qkv: SHORT_MMA_ATTENTION,
               fa.attention_fwd: SHORT_MMA_ATTENTION,
               fat.attention_bwd: "qat_vit_tpu_torch/csrc/attention_bwd_mma.cu",
               la.long_attention_qkv: "qat_vit_tpu_torch/csrc/attention_long_mma.cu",
               la.long_attention_q: "qat_vit_tpu_torch/csrc/attention_long_q_mma.cu",
               la.long_attention_bwd: "qat_vit_tpu_torch/csrc/attention_long_bwd_mma.cu",
               pg.fused_quantize_matmul: WGMMA_GEMM,
               fa.flash_attention_qkv: SHORT_MMA_ATTENTION,
               bk.megablock_forward: "qat_vit_tpu_torch/csrc/megablock.cu",
               bk.megamodel_res_forward: "qat_vit_tpu_torch/csrc/megablock.cu"}
    record = {"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"] or sources[k["wrapper"]],
         "replaces": k["replaces"], "launches": k["launches"],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        for k in kernels
    ]}
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
