"""Images whose outputs reached the host in the window over the window's
seconds (from the first batch taken to the last output on the host)."""


def read(ctx):
    return ctx.run["images"] / ctx.run["window_s"]
