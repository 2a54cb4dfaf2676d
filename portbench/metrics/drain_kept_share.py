"""Of the in-flight batches the group's drains met in the window, the share
they left in flight, in percent: the change of
``SolveGroup.counters["drain_kept"]`` (the batches a job's fetch or the
ticker left in flight where a drain of the whole deque would have fetched
them) over the change of ``drain_kept + drain_batches`` (``drain_batches``:
the batches every drain fetched). 0 where every drain takes the whole
deque; how often the drain rule engages. None where the program keeps no
such counter or its drains met no batch in the window."""


def read(ctx):
    g0, g1 = ctx["group0"], ctx["group1"]
    if "drain_kept" not in g0:
        return None
    kept = g1["drain_kept"] - g0["drain_kept"]
    met = kept + g1["drain_batches"] - g0["drain_batches"]
    if met <= 0:
        return None
    return 100.0 * kept / met
