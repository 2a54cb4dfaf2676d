"""Of the wall the group's drains waited in the solve path's fetch in the
window (``SolveGroup.counters["drain_wait_ns"]``), the share spent in the
shadow audit (``drain_audit_wait_ns``: the supervisor's wait for the audit
worker's rows of each fetched batch; where the audit runs in the process,
its solve of the sample), in percent. Above half, a fetch under
the group's lock waits for the audit more than for the card. In a traced
run the window holds the profiler's slice, its start and stop included,
which stall the jobs for a few seconds. None where the program keeps no
such counter or the drains did not wait."""


def read(ctx):
    g0, g1 = ctx["group0"], ctx["group1"]
    if "drain_wait_ns" not in g0:
        return None
    wait = g1["drain_wait_ns"] - g0["drain_wait_ns"]
    if wait <= 0:
        return None
    return 100.0 * (g1["drain_audit_wait_ns"] - g0["drain_audit_wait_ns"]) / wait
