"""The whole step's share of the card's peak: the least time of the
window's model work (the student's forward and backward, 3x the forward's
operations, at the bf16 peak; no recomputation) over the window's time."""

from portbench.lib.work import train_step_least_s


def read(ctx):
    least = train_step_least_s(ctx.arch, ctx.run["images"])
    return 100.0 * least / ctx.run["window_s"]
