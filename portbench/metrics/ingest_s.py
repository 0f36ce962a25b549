"""Per sample: the stage ``ingest`` (KMC read and sort or the sorted
sidecar; for the hash engine the KMC decode and the host table build)."""


def read(ctx):
    return ctx.per_sample(lambda c: c.stages.get("ingest", 0.0))
