"""Windows sent to the audit workers and not back when the window closed
(``AuditWorker.anatomy``), summed over the workers."""


def read(ctx):
    a = ctx["audit"]
    return None if a is None else float(a["queued"])
