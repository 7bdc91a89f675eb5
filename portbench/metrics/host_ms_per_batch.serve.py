"""Host ms per served batch: the median over the window's batches of the
benchmark's span around the predictor's forward call (pinning, the copy's
enqueue and every launch; no wait for the device)."""

from portbench.lib.readers import median_ms


def read(ctx):
    return median_ms(ctx.run["host_spans"])
