"""Seconds the solve group took to build (``SolveGroup.counters
["build_ns"]``, read at the window's start): its audit workers' start, the
ladder's tables, the supervised solve path and the capture of its graphs,
a part of ``setup_s``. The build ends before the window, which in a traced
run holds the profiler's slice, its start and stop included. None where the
program keeps no such counter."""


def read(ctx):
    ns = ctx["group0"].get("build_ns")
    if not ns:
        return None
    return ns / 1e9
