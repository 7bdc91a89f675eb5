"""Host ms to enqueue one train step: the median over the window's steps
of the benchmark's span around each step call."""

from portbench.lib.readers import median_ms


def read(ctx):
    return median_ms(ctx.run["host_spans"])
