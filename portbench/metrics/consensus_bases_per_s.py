"""Consensus bases a second: the ``cons_len`` of every solved window of
every block the jobs fetched in the window, over the window's seconds."""


def read(ctx):
    return sum(b["bases"] for b in ctx["window_blocks"]) / ctx["window_s"]
