"""The whole forward's share of the card's peak: the least time of the
window's model work (the int8 GEMMs at the int8 peak, the attention at the
bf16 peak, LayerNorm at the f32 rate) over the window's time."""

from portbench.lib.work import serve_least_s


def read(ctx):
    per_batch = serve_least_s(ctx.arch, int(ctx.traffic["batch"]))
    return 100.0 * ctx.run["batches"] * per_batch / ctx.run["window_s"]
