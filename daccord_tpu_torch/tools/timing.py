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

#: profiler sessions tried before a timing falls back to CUDA events: on the
#: H100 a session now and then records no device event, most often the
#: process's first
SESSIONS = 4


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
    profiler records no such kernel in ``SESSIONS`` sessions, the calls are
    timed with CUDA events instead: (ms, "events")."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    us = []
    for _ in range(SESSIONS):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and (name is None or name in e.name)]
        if us:
            break
    if not us:
        return event_ms(fn, reps), "events"
    if name is None:
        return sum(us) / reps / 1e3, "profiler"
    return float(np.median(us)) / 1e3, "profiler"


def alternate_ms(calls: list, turns: int) -> tuple[dict, str]:
    """Device milliseconds of several calls timed in turns: ``calls`` is a
    list of ``(label, fn)``, and each turn runs every ``fn`` once, in order,
    inside one ``torch.profiler`` session, so the calls share the card's
    clocks and its neighbours. A call's time in a turn is the device time of
    every kernel it launched (its ``record_function`` range's device
    total). Returns ({label: [ms per turn]}, "profiler"); when ``SESSIONS``
    sessions record no device time for some turn, each call is timed
    between two CUDA events in the same turns instead: (..., "events")."""
    for _ in range(2):
        for _, fn in calls:
            fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(SESSIONS):
        with torch.profiler.profile(activities=acts) as prof:
            for t in range(turns):
                for label, fn in calls:
                    with torch.profiler.record_function(f"turn{t}:{label}"):
                        fn()
            torch.cuda.synchronize()
        by_name = {e.name: e.device_time_total for e in prof.events()
                   if e.name.startswith("turn")}
        out = {label: [by_name.get(f"turn{t}:{label}", 0.0) / 1e3 for t in range(turns)]
               for label, _ in calls}
        if all(v > 0 for ms in out.values() for v in ms):
            return out, "profiler"
    out = {label: [] for label, _ in calls}
    for _ in range(turns):
        for label, fn in calls:
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            out[label].append(s.elapsed_time(e))
    return out, "events"
