"""Milliseconds a ladder call's count read took in the window: the change
of ``SolveGroup.counters["count_read_ns"]`` (the host sync that reads the
counts after tier 0 on the dispatcher's thread, waiting for tier 0 on the
card) over the change of ``count_reads``. In a traced run the window holds
the profiler's slice, its start and stop included, which stall the jobs
for a few seconds. None where the program keeps no such counter or read
no count."""


def read(ctx):
    g0, g1 = ctx["group0"], ctx["group1"]
    if "count_read_ns" not in g0:
        return None
    reads = g1["count_reads"] - g0["count_reads"]
    if reads <= 0:
        return None
    return (g1["count_read_ns"] - g0["count_read_ns"]) / 1e6 / reads
