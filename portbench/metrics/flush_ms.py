"""Milliseconds a merged batch's flush took in the window: the change of
``SolveGroup.counters["flush_ns"]`` (all of a flush, under the group's
lock: the take of the pooled rows, the merge, the pad, the supervisor's
dispatch with its audit sample) over the change of ``batches``. In a traced
run the window holds the profiler's slice, its start and stop included,
which stall the jobs for a few seconds. None where the program keeps no
such counter or flushed nothing."""


def read(ctx):
    g0, g1 = ctx["group0"], ctx["group1"]
    if "flush_ns" not in g0:
        return None
    batches = g1["batches"] - g0["batches"]
    if batches <= 0:
        return None
    return (g1["flush_ns"] - g0["flush_ns"]) / 1e6 / batches
