"""The int8 projections' share of their roofline in a served forward: the
patch, qkv, proj, fc1, fc2 and head GEMMs with their epilogues (K2a-c), by
whatever kernel computes them (the port's, K7, or a library int8 GEMM)."""

from portbench.lib.readers import roofline_pct
from portbench.lib.work import serve_gemm_works

TABLE = (
    ("gemm_resid_ln", "int8 GEMM"), ("int8_wgmma", "int8 GEMM"), ("quantize_gemm", "int8 GEMM"),
    ("s8s8", "int8 GEMM"), ("i8i8", "int8 GEMM"), ("imma", "int8 GEMM"), ("int8", "int8 GEMM"),
)


def read(ctx):
    return roofline_pct(ctx, TABLE, "int8 GEMM",
                        serve_gemm_works(ctx.arch, int(ctx.traffic["batch"])))
