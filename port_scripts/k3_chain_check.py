"""How far the ViT-S K4 chain moves from its plain twin when its attention stage (K3)
rounds otherwise, on the card, and whether a bound on that distance tells sound
attention from faulty: phase 3's ViT-S/16 export (random init from chip_smoke's seed,
PTQ over its 4 x 32 calibration images) and its first 256 images, the plain
megamodel chain (``megamodel_plain``) run with its attention stage swapped. For each
variant, the logits' rel L2 to the plain chain (index-order attention,
fused_attention_qkv_plain) and their top-1 agreement, and the same against the exact
f32 path (chip_smoke.EXACT_REL_L2):

sound (each the same math, rounded otherwise):
- kernel: K3 (qvt_attention_q_mma), with per block the count of its int8 outputs
  unlike the plain version's on the same qkv; this chain is the kernel chain, bit
  for bit (phase 3);
- plain: the plain attention: 0 by construction;
- exp2 p: p = exp2((s - max) log2e) / sum in f32 (K3's softmax, index-order dots);
- 16-dim score chunks: the scores summed over 16 head dims at a time, the partial
  sums then added in order;
- 16-key p.v chunks: p.v summed over 16 keys at a time, each partial sum added to
  o in key order;
- one flip: the plain output with one int8 value of block 0 one step up;
faults (planted):
- head zeroed: block 0's head 0 outputs the zero point (o = 0);
- last tile dropped: every block's keys of the last 64-key tile masked;
- all one step: block 0's every output one step up.

Prints the largest sound and the smallest faulty reading last: a chain bound must
lie between them.

    python3 port_scripts/k3_chain_check.py
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
from qat_vit_tpu_torch.ops import fused_serve as fs  # noqa: E402
from qat_vit_tpu_torch.ops.flash_attention import (  # noqa: E402
    _q_scale,
    ordered_dot,
    ordered_matmul,
    softmax_pinned,
    split_heads,
)
from qat_vit_tpu_torch.ops.quantized_matmul import f32  # noqa: E402
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
x = prep(torch.from_numpy(images[:cs.SERVE_B]))
bf16 = torch.bfloat16
plain_chain = int8_apply(qp, x, cfg, fused="megamodel_plain", compute_dtype=bf16)
kernel_chain = int8_apply(qp, x, cfg, fused="megamodel", compute_dtype=bf16)
exact = int8_apply(qp, x, cfg, fused="none")
TILE = 64
plain_q = fa.fused_attention_qkv_plain


def quantize(o, out_q, quant_max):
    return fs.quantize_mul(o, fs.inv_scale(out_q["scale"]), f32(out_q["zero_point"]),
                           f32(quant_max))


def reordered(kind, qkv, num_heads, head_dim, out_q, quant_max):
    """One of the sound reorderings of the plain attention (no masked keys)."""
    b, n, _ = qkv.shape
    qh, kh, vh = split_heads(qkv, num_heads, head_dim)
    qs = qh * _q_scale(head_dim, qkv.dtype).to(qkv.device)
    if kind == "16-dim score chunks":
        s = None
        for c0 in range(0, head_dim, 16):
            part = ordered_dot(qs[..., c0:c0 + 16], kh[..., c0:c0 + 16])
            s = part if s is None else s + part
    else:
        s = ordered_dot(qs, kh)
    if kind == "exp2 p":
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp2((s - m) * np.float32(1.4426950408889634))
        o = ordered_matmul((e * (1.0 / e.sum(dim=-1, keepdim=True))).to(bf16), vh)
    elif kind == "16-key p.v chunks":
        p = softmax_pinned(s).to(bf16)
        o = torch.zeros(p.shape[:-1] + vh.shape[-1:], device=p.device)
        for j0 in range(0, n, 16):
            o = o + ordered_matmul(p[..., j0:j0 + 16], vh[..., j0:j0 + 16, :])
    else:  # 16-dim score chunks
        o = ordered_matmul(softmax_pinned(s).to(bf16), vh)
    return quantize(o.transpose(1, 2).reshape(b, n, -1), out_q, quant_max)


def variant_attention(kind, flips):
    """The attention stage of one variant → shifted int8 [B, N, H*hd]."""
    block = [0]

    def attention(qkv, num_heads, head_dim, *, out_q, quant_max=255.0, n_valid=None):
        first = block[0] == 0
        block[0] += 1
        n = qkv.shape[1]
        plain = lambda nv=n_valid: plain_q(  # noqa: E731
            qkv, num_heads, head_dim, out_q=out_q, quant_max=quant_max, n_valid=nv)
        if kind == "kernel":
            got = fa.fused_attention_qkv(qkv, num_heads, head_dim, out_q=out_q,
                                         quant_max=quant_max, n_valid=n_valid)
            diff = (got.int() - plain().int()).abs()
            flips.append((int((diff > 0).sum()), got.numel(), int(diff.max())))
            return got
        if kind in ("exp2 p", "16-dim score chunks", "16-key p.v chunks"):
            return reordered(kind, qkv, num_heads, head_dim, out_q, quant_max)
        if kind == "last tile dropped":
            nv = n if n_valid is None else n_valid
            return plain(min(nv, (n - 1) // TILE * TILE))
        got = plain()
        if kind == "plain" or not first:
            return got
        top = int(quant_max) - 128
        if kind == "one flip":
            got[0, 0, 0] = min(int(got[0, 0, 0]) + 1, top)
        elif kind == "head zeroed":
            got[..., :head_dim] = int(f32(out_q["zero_point"])) - 128
        elif kind == "all one step":
            got = (got.int() + 1).clamp(max=top).to(torch.int8)
        return got
    return attention


def metrics(got, ref):
    return (cs.rel_l2(got, ref), float((got.argmax(-1) == ref.argmax(-1)).float().mean()))


SOUND = ("kernel", "plain", "exp2 p", "16-dim score chunks", "16-key p.v chunks", "one flip")
FAULTS = ("head zeroed", "last tile dropped", "all one step")
readings = {}
for kind in SOUND + FAULTS:
    flips = []
    with cs.plain_ops_with("PLAIN_OPS", attention=variant_attention(kind, flips)):
        got = int8_apply(qp, x, cfg, fused="megamodel_plain", compute_dtype=bf16)
    rel, top1 = metrics(got, plain_chain)
    rel_x, top1_x = metrics(got, exact)
    readings[kind] = rel
    print(f"{kind}: logits rel L2 to the plain chain {rel:.3e} (top-1 agreement {top1:.4f}); "
          f"vs exact: rel L2 {rel_x:.3e} (bound {cs.EXACT_REL_L2}), top-1 {top1_x:.4f}",
          flush=True)
    if flips:
        print(f"{kind}: int8 outputs unlike plain per block "
              + ", ".join(f"{a}/{n} (max {m})" for a, n, m in flips)
              + f"; identical to the kernel chain {torch.equal(got, kernel_chain)}", flush=True)
sound = max(readings[k] for k in SOUND)
faulty = min(readings[k] for k in FAULTS)
print(f"largest sound reading {sound:.3e}, smallest faulty {faulty:.3e}: "
      + ("a bound between them separates" if sound < faulty else "no bound separates"),
      flush=True)
