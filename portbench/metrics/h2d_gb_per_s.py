"""The device join's host-to-device rate over the window: every byte it
copies to the card (counter ``djoin_h2d_bytes``: the sample's tiles and
the per-call statics) over the seconds of those copies (stages
``djoin_upload`` and ``djoin_static_upload``), summed over the calls."""


def read(ctx):
    if not ctx.calls or any(c.stages is None
                            or "djoin_h2d_bytes" not in c.stages
                            for c in ctx.calls):
        return None
    nbytes = sum(c.stages["djoin_h2d_bytes"] for c in ctx.calls)
    secs = sum(c.stages.get("djoin_upload", 0.0)
               + c.stages.get("djoin_static_upload", 0.0) for c in ctx.calls)
    if secs <= 0:
        return None
    return nbytes / 1e9 / secs
