"""Share of the memory roofline of the hash engine's probe and scan
kernels (csrc/hashscan.cu) over the window: the features' problem bytes
(yardstick.hash_bytes, per sample of every call) at the peak over the
kernels' device time."""

KERNELS = ("hash_probe", "hash_scan")


def read(ctx):
    from portbench.yardstick import hash_bytes

    def nbytes(c):
        return sum(hash_bytes(ctx.sizes["bases"], ctx.sizes["kmers"],
                              ctx.sizes["windows"], ctx.samples[i]["width"])
                   for i in c.samples)

    return ctx.roofline(KERNELS, nbytes)
