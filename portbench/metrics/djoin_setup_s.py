"""Per sample: the device join's set-up in every call (stage
``djoin_setup``: the reference k-mers routed into query tiles, the slab
statics built on the host, and both uploaded)."""


def read(ctx):
    if not ctx.calls or any(c.stages is None or "djoin_setup" not in c.stages
                            for c in ctx.calls):
        return None
    return ctx.per_sample(lambda c: c.stages["djoin_setup"])
