"""Share of the memory roofline of the device join's window scan
(csrc/gapscan.cu, JOIN mode) over the window: the scan's problem bytes
(yardstick.scan_bytes, per sample of every call) at the peak over the
kernels' device time."""

KERNELS = ("join_chunks", "join_windows")


def read(ctx):
    from portbench.yardstick import scan_bytes

    def nbytes(c):
        return sum(scan_bytes(ctx.kmer_positions, ctx.sizes["distinct"],
                              ctx.sizes["windows"], ctx.samples[i]["width"])
                   for i in c.samples)

    return ctx.roofline(KERNELS, nbytes)
