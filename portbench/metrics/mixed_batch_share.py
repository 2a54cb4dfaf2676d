"""Merged batches in the window that hold rows of more than one job
(``SolveGroup.counters``: mixed_batches / batches), in percent."""


def read(ctx):
    g0, g1 = ctx["group0"], ctx["group1"]
    batches = g1["batches"] - g0["batches"]
    if batches <= 0:
        return None
    return 100.0 * (g1["mixed_batches"] - g0["mixed_batches"]) / batches
