"""Kernel A's share of its roofline in the train step: the attention
forward over the packed qkv (bf16, the qkv fake-quant inside), by whatever
kernel computes it (the port's, or the library's flash / fused kernels)."""

from portbench.lib.readers import roofline_pct
from portbench.lib.work import attn_train_works

TABLE = (
    ("attention_bwd", "backward"), ("flash_bwd", "backward"), ("fmha_cutlassb", "backward"),
    ("bwd", "backward"), ("bprop", "backward"),
    ("long_attention", "long"),
    ("attention_q_mma", "attention forward"), ("attention_f32_fwd", "attention forward"),
    ("flash", "attention forward"), ("fmha", "attention forward"), ("sdpa", "attention forward"),
)


def read(ctx):
    fwd, _ = attn_train_works(ctx.arch, int(ctx.traffic["batch"]))
    return roofline_pct(ctx, TABLE, "attention forward", [fwd] * ctx.arch.depth)
