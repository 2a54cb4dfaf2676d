"""Rows of the merged batches flushed in the window over their slots, in
percent: the rows the jobs dispatched (``SolveGroup.counters``), less what
the group's pools gained in the window, over batches x width."""


def read(ctx):
    g0, g1 = ctx["group0"], ctx["group1"]
    batches = g1["batches"] - g0["batches"]
    if batches <= 0:
        return None
    flushed = g1["rows"] - g0["rows"] - (ctx["pooled1"] - ctx["pooled0"])
    return 100.0 * flushed / (batches * ctx["width"])
