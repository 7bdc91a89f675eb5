"""Kernel B's share of its roofline in the train step: the attention
backward (rows and keys passes together), by whatever kernel computes it."""

from portbench.lib.readers import roofline_pct
from portbench.lib.work import attn_train_works

TABLE = (
    ("long_bwd", "long"),
    ("attention_bwd", "attention backward"), ("attention_f32_bwd", "attention backward"),
    ("flash_bwd", "attention backward"), ("fmha_cutlassb", "attention backward"),
    ("sdpa_bwd", "attention backward"), ("dot_product_attention_bwd", "attention backward"),
    ("bprop", "attention backward"), ("sdpa", "other attention"),
)


def read(ctx):
    _, bwd = attn_train_works(ctx.arch, int(ctx.traffic["batch"]))
    return roofline_pct(ctx, TABLE, "attention backward", [bwd] * ctx.arch.depth)
