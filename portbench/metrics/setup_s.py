"""Seconds from the process's start to the window's start: imports,
inputs and weights, the program's set-up, the kernels' build or load, the
warm-up."""


def read(ctx):
    return ctx.run["setup_s"]
