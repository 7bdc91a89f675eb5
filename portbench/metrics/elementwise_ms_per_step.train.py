"""Device ms per train step outside attention and GEMMs: fake-quant,
observers, LayerNorm, activations, casts, the loss and AdamW (every kernel
this table does not name, unknown names included)."""

from portbench.lib.readers import device_ms_per_step

TABLE = (
    ("attention_q_mma", "attention"), ("attention_bwd", "attention"),
    ("attention_f32", "attention"), ("long_attention", "attention"), ("long_bwd", "attention"),
    ("flash", "attention"), ("fmha", "attention"), ("sdpa", "attention"),
    ("gemm", "gemm"), ("gemv", "gemm"), ("nvjet", "gemm"), ("cutlass", "gemm"), ("xmma", "gemm"),
    ("sm90_", "gemm"), ("cublas", "gemm"), ("nccl", "collective"),
)


def read(ctx):
    return device_ms_per_step(ctx, TABLE, ("other",))
