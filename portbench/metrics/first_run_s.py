"""Seconds of the run's first call, made with no reference index,
window plan or sorted sidecar on disk."""


def read(ctx):
    return ctx.first_run_s
