"""The program's own ranges in a traced run, read back from
``records["host_events"]``: the ranges that
``repro_torch.obs.profiled`` opens around each serving stage while a profiler
records (``gateway.cache_probe``, ``batcher.assemble``, ``plan.shard``,
``backend.rows_in``, ...).

A profiler keeps the ranges of the threads it records.  ``devtrace.Profiled``
records the thread that starts it, which is the event loop in the gateway's
cells and no thread of the program in the bulk cells, whose client threads
call the engine.
"""
from __future__ import annotations

from portbench import devtrace

# the first words of the program's range names, one per layer that opens them
PREFIXES = ("gateway.", "batcher.", "engine.", "plan.", "backend.")


def ranges(records: dict) -> list:
    """``(name, start_us, dur_us)`` of each of the program's ranges that starts
    inside the traced window."""
    if "host_events" not in records:
        return []
    t0, t1 = records["trace_window"]
    return [h for h in records["host_events"]
            if h[0].startswith(PREFIXES) and t0 <= h[1] <= t1]


def union(intervals) -> list:
    """The ``(start, end)`` intervals merged where they overlap, in order."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def idle_unspanned_us(device_events: list, host_ranges: list, t0_us: float,
                      t1_us: float) -> float:
    """Microseconds of ``[t0, t1]`` with nothing on the device and none of
    ``host_ranges`` open, on whichever thread."""
    covered = union((s, s + d) for _, s, d in host_ranges)
    total, i = 0.0, 0
    for g0, length in devtrace.idle_gaps(device_events, t0_us, t1_us):
        g1 = g0 + length
        total += length
        while i < len(covered) and covered[i][1] <= g0:
            i += 1
        j = i
        while j < len(covered) and covered[j][0] < g1:
            total -= min(g1, covered[j][1]) - max(g0, covered[j][0])
            j += 1
    return total
