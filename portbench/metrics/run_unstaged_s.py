"""Per sample: a call's wall seconds less the stages the program times
on the main thread (the CLI, the index, plan and FASTA loads, the GTF,
the device join's routing of the reference, the table upload of the
hash engine: what no stage covers). Stages nested in another (the
device join's fetch inside ``scan``) are not subtracted twice; ``ingest``
runs on a worker thread in calls of more than one sample and is
subtracted only in one-sample calls."""

TOP_LEVEL = ("djoin_pack", "djoin_upload", "djoin_join", "djoin_scan",
             "scan", "write", "merge", "merge_streamed", "mesh_place")


def read(ctx):
    def unstaged(c):
        st = c.stages
        staged = sum(st.get(s, 0.0) for s in TOP_LEVEL)
        if len(c.samples) == 1:
            staged += st.get("ingest", 0.0)
        return c.wall_s - staged

    return ctx.per_sample(unstaged)
