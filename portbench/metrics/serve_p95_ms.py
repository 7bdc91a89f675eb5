"""The 95th percentile of the window's batch latencies: from when the
predictor takes a batch to when its outputs are on the host."""

from portbench.lib.common import percentile


def read(ctx):
    lat = ctx.run["latencies_s"]
    return 1e3 * percentile(lat, 95.0) if lat else None
