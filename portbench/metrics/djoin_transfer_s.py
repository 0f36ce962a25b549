"""Per sample: the device join's host-to-device and device-to-host
copies (stages ``djoin_upload`` and ``djoin_fetch``)."""


def read(ctx):
    v = ctx.per_sample(lambda c: c.stages.get("djoin_upload", 0.0)
                       + c.stages.get("djoin_fetch", 0.0))
    return v or None
