"""Per sample: the reference's loads in every call (stages
``fasta_index``, ``refindex_load``, ``plan_load`` and ``gtf_parse``:
the FASTA index, the reference k-mer index, the window plan and the
GTF, each read from its cache or built)."""

STAGES = ("fasta_index", "refindex_load", "plan_load", "gtf_parse")


def read(ctx):
    if not ctx.calls or any(c.stages is None or "fasta_index" not in c.stages
                            for c in ctx.calls):
        return None
    return ctx.per_sample(lambda c: sum(c.stages.get(s, 0.0)
                                        for s in STAGES))
