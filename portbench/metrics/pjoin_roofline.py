"""Share of the memory roofline of the device join's kernels
(csrc/pjoin.cu) over the window: the join's problem bytes
(yardstick.join_bytes, per sample of every call) at the peak over the
kernels' device time."""

KERNELS = ("pjoin_staged", "pjoin_chunked")


def read(ctx):
    from portbench.yardstick import join_bytes

    def nbytes(c):
        return sum(join_bytes(ctx.sizes["distinct"], ctx.samples[i]["keys"],
                              ctx.samples[i]["width"]) for i in c.samples)

    return ctx.roofline(KERNELS, nbytes)
