"""Per sample: the hash engine's stage ``scan`` (splicing, padding,
uploads, the probe and scan kernels, fetches)."""


def read(ctx):
    v = ctx.per_sample(lambda c: c.stages.get("scan", 0.0))
    return v or None
