"""Per sample: what no stage inside the program covers in a call (the
self time of the root stage ``getVariations``: its seconds less those of
the stages it holds on its thread)."""


def read(ctx):
    key = "getVariations.self"
    if not ctx.calls or any(c.stages is None or key not in c.stages
                            for c in ctx.calls):
        return None
    return ctx.per_sample(lambda c: c.stages[key])
