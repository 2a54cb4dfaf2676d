"""Device times of the port's kernels on a CUDA card.

:func:`event_ms` brackets each call with a pair of CUDA events; it is right
for work that keeps the card busy for longer than the host takes to issue
it (the plain torch versions, a ladder call). A single kernel launch shorter
than its wrapper's host work (~0.1 ms) would be timed as that host work, so
:func:`kernel_ms` reads the kernel's own duration from ``torch.profiler``'s
device events instead.
"""

from __future__ import annotations

import numpy as np
import torch


def event_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, each between two
    CUDA events, after two warm-up runs."""
    for _ in range(2):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def kernel_ms(fn, name: str | None, reps: int) -> tuple[float, str]:
    """Device milliseconds of one call of ``fn`` from ``torch.profiler``'s
    device events over ``reps`` calls (after two warm-up calls): the median
    duration of the kernel whose name contains ``name``, which each call
    launches once, or, with ``name`` None, the summed duration of every
    kernel the calls launched, divided by ``reps``: (ms, "profiler"). If the
    profiler records no such kernel, the calls are timed with CUDA events
    instead: (ms, "events")."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and (name is None or name in e.name)]
    if not us:
        return event_ms(fn, reps), "events"
    if name is None:
        return sum(us) / reps / 1e3, "profiler"
    return float(np.median(us)) / 1e3, "profiler"
