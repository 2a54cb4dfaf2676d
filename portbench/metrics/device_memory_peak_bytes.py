"""The card's peak allocated bytes over the run
(``torch.cuda.max_memory_allocated``): the group's graphs, buffers and
tables and the batches in flight."""


def read(ctx):
    return ctx["memory_peak_bytes"]
