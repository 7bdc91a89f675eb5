"""Images trained in the window over the window's seconds,
the window ending in a synchronize."""


def read(ctx):
    return ctx.run["images"] / ctx.run["window_s"]
