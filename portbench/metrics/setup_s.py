"""Seconds from the start of the process to the start of the window:
inputs made, kernels built or loaded, the first call and the warm-up
calls."""


def read(ctx):
    return ctx.setup_s
