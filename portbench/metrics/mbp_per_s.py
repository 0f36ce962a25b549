"""Reference megabases screened per second: every window call's
reference length x samples over the whole window, last call included."""


def read(ctx):
    if not ctx.calls or ctx.window_s <= 0:
        return None
    return sum(c.work_bp for c in ctx.calls if c.rc == 0) / 1e6 / ctx.window_s
