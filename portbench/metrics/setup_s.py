"""Process start to the window's first timed dispatch: CUDA's start, the
kernels' libraries, the inputs, the audit workers, the group's graph
captures and the warm-up of the cell's own traffic."""


def read(ctx):
    return ctx["setup_s"]
