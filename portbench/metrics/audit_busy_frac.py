"""The shadow audit workers' own solve wall in the window
(``AuditWorker.worker_s``) over the window times the worker processes, in
percent: how near the audit is to setting the pace."""


def read(ctx):
    a = ctx["audit"]
    if a is None or not a["processes"]:
        return None
    return 100.0 * (a["worker_s1"] - a["worker_s0"]) / (ctx["window_s"] * a["processes"])
