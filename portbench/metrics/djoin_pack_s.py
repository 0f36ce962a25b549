"""Per sample: the device join's table pack (stage ``djoin_pack``)."""


def read(ctx):
    v = ctx.per_sample(lambda c: c.stages.get("djoin_pack", 0.0))
    return v or None
