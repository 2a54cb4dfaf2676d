"""The 95th percentile, over every block fetched in the window, of the
time from its dispatch to the return of its fetch: what a job's pile loop
waits for its rows on the shared card."""

import numpy as np


def read(ctx):
    lat = [b["latency_s"] for b in ctx["window_blocks"]]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
