"""The device's idle share over the profiled train steps: 1 - busy / span,
busy the union of the kernels' intervals, span from the first kernel's
start to the last one's end."""

from portbench.lib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
