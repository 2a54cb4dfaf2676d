"""The wall the solve group's lock was held in the window over the
window, in percent: the change of ``SolveGroup.counters["lock_held_ns"]``
(each outermost hold of the group's lock, acquire to release, on every
path that takes it) between the window's two readings. In a traced run the
window holds the profiler's slice, its start and stop included, which stall
the jobs for a few seconds. None where the program keeps no such counter."""


def read(ctx):
    g0, g1, w = ctx["group0"], ctx["group1"], ctx["window_s"]
    if "lock_held_ns" not in g0 or w <= 0:
        return None
    return 100.0 * (g1["lock_held_ns"] - g0["lock_held_ns"]) / 1e9 / w
