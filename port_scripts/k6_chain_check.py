"""How far the K6 chain moves from its plain twin when its attention stage rounds
otherwise, on the card, and whether the detection bounds tell sound attention from
faulty: phase 5's OWLv2-pruned export and inputs (batch 2, 4 queries), the
megamodel_long chain run with its attention stage swapped. For each variant, every
output's rel L2 to the plain chain (index-order attention,
long_attention_qkv_plain with out_q) and the exact-path metrics of chip_smoke.py
(pred_boxes mean |err|, correlation of logits and objectness_logits against the
exact f32 path):

sound (each the same math, rounded otherwise):
- kernel: K6a (qvt_attention_long_q_mma), with per block the count of its int8
  outputs unlike the plain version's on the same qkv;
- plain: the plain attention: 0 by construction;
- exp2 p: p = exp2((s - max) log2e) / sum in f32 (K6a's softmax, index-order dots);
- 16-dim score chunks: the scores summed over 16 head dims at a time, the partial
  sums then added in order;
- 16-key p.v chunks: p.v summed over 16 keys at a time, each partial sum added to
  o in key order;
- one flip: the plain output with one int8 value of block 0 one step up;
faults (planted):
- head zeroed: block 0's head 0 outputs the zero point (o = 0);
- last tile dropped: every block's keys of the last 64-key tile masked;
- all one step: block 0's every output one step up;
and the i8 chain (megamodel_long:...:i8) against its own plain twin.

    python3 port_scripts/k6_chain_check.py
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from qat_vit_tpu_torch.models.registry import create_model  # noqa: E402
from qat_vit_tpu_torch.ops import fused_serve as fs  # noqa: E402
from qat_vit_tpu_torch.ops import long_attention as la  # noqa: E402
from qat_vit_tpu_torch.ops.flash_attention import (  # noqa: E402
    _q_scale,
    ordered_dot,
    ordered_matmul,
    softmax_pinned,
    split_heads,
)
from qat_vit_tpu_torch.ops.quantized_matmul import f32  # noqa: E402
from qat_vit_tpu_torch.serve.calibrate import calibrate_detector  # noqa: E402
from qat_vit_tpu_torch.serve.int8_detect import (  # noqa: E402
    convert_detector,
    int8_detect_apply,
    make_int8_detect_forward,
)
from qat_vit_tpu_torch.serve.int8_vit import export_to_device  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
print(cs.card_line(), flush=True)
bundle = create_model("owlv2_pruned_detector", qat_wrapper=True,
                      generator=torch.Generator().manual_seed(cs.SEED), device=dev)
cfg = bundle.cfg
params = {k: v for k, v in bundle.module.state_dict().items()
          if not k.endswith(("min_val", "max_val"))}
calib = [cs.det_inputs(torch, np, cs.SEED + 10 + i, 1, dev)[0] for i in range(cs.DET_CALIB)]
export = export_to_device(convert_detector(params, calibrate_detector(params, calib, cfg,
                                                                       device=dev), cfg), dev)
x, q = cs.det_inputs(torch, np, cs.SEED + 20, cs.DET_B, dev)
x, q = x[:cs.DET_REF_B], q[:cs.DET_REF_B]
opts = make_int8_detect_forward(cfg, dev).options
plain_chain = int8_detect_apply(export, x, cfg, q, **{**opts, "fused": "megamodel_long_plain"})
exact = int8_detect_apply(export, x, cfg, q)
kernel_q = la.long_attention_q
TILE = 64


def quantize(o, out_q, quant_max):
    return fs.quantize_mul(o, fs.inv_scale(out_q["scale"]), f32(out_q["zero_point"]),
                           f32(quant_max))


def reordered(kind, qkv, num_heads, head_dim, out_q, quant_max):
    """One of the sound reorderings of the plain attention (no masked keys)."""
    b, n, _ = qkv.shape
    out = torch.empty(b, n, num_heads * head_dim, dtype=torch.float32, device=qkv.device)
    for i in range(b):
        qh, kh, vh = split_heads(qkv[i:i + 1], num_heads, head_dim)
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
            o = ordered_matmul((e * (1.0 / e.sum(dim=-1, keepdim=True))).to(torch.bfloat16), vh)
        elif kind == "16-key p.v chunks":
            p = softmax_pinned(s).to(torch.bfloat16)
            o = torch.zeros(p.shape[:-1] + vh.shape[-1:], device=p.device)
            for j0 in range(0, n, 16):
                o = o + ordered_matmul(p[..., j0:j0 + 16], vh[..., j0:j0 + 16, :])
        else:  # 16-dim score chunks
            o = ordered_matmul(softmax_pinned(s).to(torch.bfloat16), vh)
        out[i] = o[0].transpose(0, 1).reshape(n, -1)
    return quantize(out, out_q, quant_max)


def variant_attention(kind, flips):
    """The attention stage of one variant → shifted int8 [B, N, H*hd]."""
    block = [0]

    def attention(qkv, num_heads, head_dim, *, out_q, quant_max=255.0, n_valid=None):
        first = block[0] == 0
        block[0] += 1
        n = qkv.shape[1]
        plain = lambda nv=n_valid: la.long_attention_qkv_plain(  # noqa: E731
            qkv, num_heads, head_dim, out_q=out_q, quant_max=quant_max, n_valid=nv)
        if kind == "kernel":
            got = kernel_q(qkv, num_heads, head_dim, out_q=out_q, quant_max=quant_max,
                           n_valid=n_valid)
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
    attention.launches = 0  # the wrapper counts its launches under its module name
    return attention


def exact_metrics(got):
    box = float((got["pred_boxes"] - exact["pred_boxes"]).abs().mean())
    corr = [float(np.corrcoef(got[k].flatten().cpu().numpy(),
                              exact[k].flatten().cpu().numpy())[0, 1])
            for k in ("logits", "objectness_logits")]
    return f"box err {box:.3e}, corr logits {corr[0]:.5f} objectness {corr[1]:.5f}"


for kind in ("kernel", "plain", "exp2 p", "16-dim score chunks", "16-key p.v chunks",
             "one flip", "head zeroed", "last tile dropped", "all one step"):
    flips = []
    la.long_attention_q = variant_attention(kind, flips)
    try:
        got = int8_detect_apply(export, x, cfg, q, **{**opts, "fused": "megamodel_long"})
    finally:
        la.long_attention_q = kernel_q
    rels = {k: cs.rel_l2(got[k].float(), plain_chain[k].float()) for k in plain_chain}
    print(f"{kind}: rel L2 to the plain chain "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()) + f"; vs exact: "
          + exact_metrics(got), flush=True)
    if flips:
        print(f"{kind}: int8 outputs unlike plain per block "
              + ", ".join(f"{a}/{n} (max {m})" for a, n, m in flips), flush=True)

i8 = int8_detect_apply(export, x, cfg, q, **{**opts, "fused": "megamodel_long:512:256:i8"})
i8_plain = int8_detect_apply(export, x, cfg, q,
                             **{**opts, "fused": "megamodel_long_plain:512:256:i8"})
rels = {k: cs.rel_l2(i8[k].float(), i8_plain[k].float()) for k in i8_plain}
print("kernel i8: rel L2 to the plain i8 chain "
      + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()) + "; vs exact: " + exact_metrics(i8),
      flush=True)
