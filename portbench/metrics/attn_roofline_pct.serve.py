"""The attention's share of its roofline in a served forward: K3 (197
tokens) or K6a (2,305 tokens), bf16 qkv in, int8 out on the qkv output's
grid, by whatever kernel computes it."""

from portbench.lib.readers import roofline_pct
from portbench.lib.work import serve_attention_works

TABLE = (
    ("long_attention_q_mma", "attention"), ("attention_q_mma", "attention"),
    ("long_attention_mma", "attention"), ("attention_f32_fwd", "attention"),
    ("flash", "attention"), ("fmha", "attention"), ("sdpa", "attention"),
)


def read(ctx):
    return roofline_pct(ctx, TABLE, "attention",
                        serve_attention_works(ctx.arch, int(ctx.traffic["batch"])))
