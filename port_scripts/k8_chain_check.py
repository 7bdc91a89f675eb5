"""How far phase 7's `mixed` + `pallas` chain moves from its all-plain twin when its
attention stage (the bf16 K8) rounds otherwise, on the card, and whether a bound on
that distance tells sound attention from faulty: phase 3's ViT-S/16 export (random
init from chip_smoke's seed, PTQ over its 4 x 32 calibration images) and its first
32 images, the plain twin (``fused="mixed_plain", attn_impl="pallas"`` with the bf16
preset) run with its float attention stage swapped. For each variant, the logits'
rel L2 to the all-plain twin (index-order attention, flash_attention_qkv_plain) and
their top-1 agreement, and the same against the exact f32 path
(chip_smoke.EXACT_REL_L2):

sound (each the same math, rounded otherwise):
- kernel: K8 (qvt_flash_attention_mma), with per block its worst |diff| to the plain
  version; this chain is the kernel chain, bit for bit (phase 7);
- plain: the plain attention: 0 by construction;
- exp2 p: p = exp2((s - max) log2e) / sum in f32 (the kernel's softmax, index-order
  dots);
- 16-dim score chunks: the scores summed over 16 head dims at a time, the partial
  sums then added in order;
- 16-key p.v chunks: p.v summed over 16 keys at a time, each partial sum added to o
  in key order;
- one ulp: the plain output with one bf16 value of block 0 one step up;
faults (planted):
- head zeroed: block 0's head 0 outputs zero;
- last tile dropped: every block's keys of the last 64-key tile masked;
- block 0 one step: block 0's every output one bf16 step up;
- scaled twice: every block's scores scaled by hd^-0.5 twice.

Prints the largest sound and the smallest faulty reading last: a chain bound must
lie between them.

    python3 port_scripts/k8_chain_check.py
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from qat_vit_tpu_torch.data.pipeline import preprocess_fn  # noqa: E402
from qat_vit_tpu_torch.models.registry import create_student  # noqa: E402
from qat_vit_tpu_torch.ops import flash_attention as fa  # noqa: E402
from qat_vit_tpu_torch.ops.flash_attention import (  # noqa: E402
    ordered_dot,
    ordered_matmul,
    softmax_pinned,
    split_heads,
)
from qat_vit_tpu_torch.serve import int8_vit  # noqa: E402
from qat_vit_tpu_torch.serve.calibrate import ptq_convert  # noqa: E402
from qat_vit_tpu_torch.serve.int8_vit import export_to_device, int8_apply  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
print(cs.card_line(), flush=True)
# phase 3's export and images
bundle = create_student("vit", generator=torch.Generator().manual_seed(cs.SEED), device=dev)
cfg = bundle.cfg
rng = np.random.default_rng(cs.SEED + 1)
prep = preprocess_fn(cfg.image_size, device=dev)
calib = [prep(torch.from_numpy(rng.integers(0, 256, (cs.CALIB_B, 32, 32, 3), dtype=np.uint8)))
         for _ in range(cs.CALIB_BATCHES)]
qp = export_to_device(ptq_convert(bundle.module.state_dict(), calib, cfg, device=dev), dev)
images = np.random.default_rng(cs.SEED + 2).integers(0, 256, (cs.N_IMAGES, 32, 32, 3),
                                                     dtype=np.uint8)
x = prep(torch.from_numpy(images[:cs.B_KERNEL]))
bf16 = torch.bfloat16
preset = {"attn_dtype": bf16, "compute_dtype": bf16, "gelu_approx": True}
plain_chain = int8_apply(qp, x, cfg, fused="mixed_plain", attn_impl="pallas", **preset)
kernel_chain = int8_apply(qp, x, cfg, fused="mixed", attn_impl="pallas", **preset)
exact = int8_apply(qp, x, cfg, fused="none")
TILE = 64
LOG2E = np.float32(1.4426950408889634)
plain_k8 = fa.flash_attention_qkv_plain


def reordered(kind, qkv, num_heads, head_dim):
    """One of the sound reorderings of the plain attention, or the scaled-twice
    fault (no masked keys)."""
    b, n, _ = qkv.shape
    q, k, v = split_heads(qkv, num_heads, head_dim)
    scale = torch.tensor(head_dim ** -0.5, dtype=torch.float32, device=qkv.device)
    if kind == "16-dim score chunks":
        s = None
        for c0 in range(0, head_dim, 16):
            part = ordered_dot(q[..., c0:c0 + 16], k[..., c0:c0 + 16])
            s = part if s is None else s + part
        s = s * scale
    else:
        s = ordered_dot(q, k) * scale
    if kind == "scaled twice":
        s = s * scale
    if kind == "exp2 p":
        e = torch.exp2((s - s.amax(dim=-1, keepdim=True)) * LOG2E)
        o = ordered_matmul((e * (1.0 / e.sum(dim=-1, keepdim=True))).to(bf16), v)
    elif kind == "16-key p.v chunks":
        p = softmax_pinned(s).to(bf16)
        o = torch.zeros(p.shape[:-1] + v.shape[-1:], device=p.device)
        for j0 in range(0, n, 16):
            o = o + ordered_matmul(p[..., j0:j0 + 16], v[..., j0:j0 + 16, :])
    else:  # 16-dim score chunks, scaled twice
        o = ordered_matmul(softmax_pinned(s).to(bf16), v)
    return o.transpose(1, 2).reshape(b, n, -1).to(qkv.dtype)


def one_step_up(t):
    """Each bf16 value one step away from zero (the next representable)."""
    bits = t.view(torch.int16)
    return torch.where(t != 0, bits + 1, bits).view(bf16)


def variant_attention(kind, worst):
    """The float attention stage of one variant → bf16 [B, N, H*hd]."""
    block = [0]

    def attention(qkv, num_heads, head_dim, *, n_valid=None):
        first = block[0] == 0
        block[0] += 1
        n = qkv.shape[1]
        if kind == "kernel":
            got = fa.flash_attention_qkv(qkv, num_heads, head_dim, n_valid=n_valid)
            want = plain_k8(qkv, num_heads, head_dim, n_valid=n_valid)
            worst.append(float((got.float() - want.float()).abs().max()))
            return got
        if kind in ("exp2 p", "16-dim score chunks", "16-key p.v chunks", "scaled twice"):
            return reordered(kind, qkv, num_heads, head_dim)
        if kind == "last tile dropped":
            return plain_k8(qkv, num_heads, head_dim, n_valid=(n - 1) // TILE * TILE)
        got = plain_k8(qkv, num_heads, head_dim, n_valid=n_valid)
        if kind == "plain" or not first:
            return got
        if kind == "one ulp":
            got[0, 0, :1] = one_step_up(got[0, 0, :1])
        elif kind == "head zeroed":
            got[..., :head_dim] = 0
        elif kind == "block 0 one step":
            got = one_step_up(got)
        return got
    return attention


def metrics(got, ref):
    return (cs.rel_l2(got, ref), float((got.argmax(-1) == ref.argmax(-1)).float().mean()))


SOUND = ("kernel", "plain", "exp2 p", "16-dim score chunks", "16-key p.v chunks", "one ulp")
FAULTS = ("head zeroed", "last tile dropped", "block 0 one step", "scaled twice")
readings = {}
for kind in SOUND + FAULTS:
    worst = []
    int8_vit.flash_attention_qkv_plain = variant_attention(kind, worst)
    try:
        got = int8_apply(qp, x, cfg, fused="mixed_plain", attn_impl="pallas", **preset)
    finally:
        int8_vit.flash_attention_qkv_plain = plain_k8
    rel, top1 = metrics(got, plain_chain)
    rel_x, top1_x = metrics(got, exact)
    readings[kind] = rel
    print(f"{kind}: logits rel L2 to the all-plain twin {rel:.3e} (top-1 agreement "
          f"{top1:.4f}); vs exact: rel L2 {rel_x:.3e} (bound {cs.EXACT_REL_L2}), top-1 "
          f"{top1_x:.4f}", flush=True)
    if worst:
        print(f"{kind}: worst |diff| to the plain version per block "
              + ", ".join(f"{w:.3e}" for w in worst)
              + f"; identical to the kernel chain {torch.equal(got, kernel_chain)}", flush=True)
sound = max(readings[k] for k in SOUND)
faulty = min(readings[k] for k in FAULTS)
print(f"largest sound reading {sound:.3e}, smallest faulty {faulty:.3e}: "
      + ("a bound between them separates" if sound < faulty else "no bound separates"),
      flush=True)
