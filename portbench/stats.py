"""Arithmetic the metric readers share, over the records of one run.

``records["requests"]`` holds ``(sent, answered, rows, ok)`` on the host clock
for every request of the window; ``t0`` is the window's start and ``t1`` the
last answer.  A traced run adds ``device_events``, ``host_events`` and
``trace_window`` (``portbench.devtrace``), and ``batches``: the real rows of
each launch, in order.
"""
from __future__ import annotations

import numpy as np

from portbench import catalog, devtrace


def window_s(records: dict) -> float:
    return records["t1"] - records["t0"]


def rows_answered(records: dict) -> int:
    return sum(r[2] for r in records["requests"] if r[3])


def p95_ms(records: dict):
    lat = [(r[1] - r[0]) * 1e3 for r in records["requests"] if r[3]]
    return float(np.percentile(lat, 95)) if lat else None


def window_events(records: dict) -> list:
    """The device operations that start inside the traced window."""
    if "device_events" not in records:
        return []
    t0, t1 = records["trace_window"]
    return [e for e in records["device_events"] if t0 <= e[2] <= t1]


def kernel_roofline(records: dict, cfg: dict, pattern):
    """Counted least time (by the configuration's family) over measured time,
    in %, of the launches of one walk kernel.  Each launch of the walk kernels
    (``devtrace.WALK`` or ``pattern``) is paired, in order, with one batch; a
    count that does not pair up, or no launch of ``pattern``, reads nothing."""
    walks = [e for e in window_events(records)
             if e[0] == "kernel" and (devtrace.WALK.search(e[1]) or pattern.search(e[1]))]
    batches = records.get("batches", [])
    if len(walks) != len(batches):
        return None
    mine = [(e, rows) for e, rows in zip(walks, batches) if pattern.search(e[1])]
    if not mine:
        return None
    bound_s = catalog.family(cfg).bound_s
    least = sum(bound_s(cfg, rows)[0] for _, rows in mine)
    took = sum(e[3] for e, _ in mine) * 1e-6
    return 100.0 * least / took if took > 0 else None
