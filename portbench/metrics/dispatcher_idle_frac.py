"""The wall the ladder dispatcher's thread sat blocked on its empty queue
in the window over the window, in percent: the change of
``SolveGroup.counters["dispatcher_idle_ns"]`` (each call's wait in the
queue's ``get`` before the dispatcher took it, booked when the call is
drained). In a traced run the window holds the profiler's slice, its start
and stop included, which stall the jobs for a few seconds. None where the
program keeps no such counter."""


def read(ctx):
    g0, g1, w = ctx["group0"], ctx["group1"], ctx["window_s"]
    if "dispatcher_idle_ns" not in g0 or w <= 0:
        return None
    return 100.0 * (g1["dispatcher_idle_ns"] - g0["dispatcher_idle_ns"]) / 1e9 / w
