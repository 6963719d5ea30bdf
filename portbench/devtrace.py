"""The traced run's device record: a ``torch.profiler`` trace of the window,
read back from its Chrome-trace export.

``device_events`` are the operations that ran on the card (``kernel``,
``gpu_memcpy``, ``gpu_memset``) as ``(cat, name, start_us, dur_us)``;
``host_events`` the host's torch operations, runtime calls and annotations as
``(name, start_us, dur_us)``.  Both are on the profiler's clock.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import warnings

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# the walk kernels of csrc/tree_traverse.cu (walk_tile<K, Walk, staged>) and the
# QuickScorer kernel of csrc/bitvector.cu, as the profiler prints their symbols:
# "void (anonymous namespace)::walk_tile<4, ((anonymous namespace)::Walk)0, true>(...)"
# for K1, the bounded walk (Walk::kBounded, the enum's first value)
WALK = re.compile(r"walk_tile<")
K1 = re.compile(r"walk_tile<\d+,\s*[^,]*Walk(\)0|::kBounded)")
K5 = re.compile(r"bitvector_tile<")
# the harness's mark around the measured window
WINDOW = "portbench.window"


class Profiled:
    """Profile the card and the host between ``__enter__`` and ``__exit__``."""

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        # one profiling cycle here, so the note that cycles clear their events is noise
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def events(self) -> tuple:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                trace = json.load(fh)
        finally:
            os.unlink(path)
        return split_events(trace.get("traceEvents", []))


def split_events(events: list) -> tuple:
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((cat, e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
        elif cat in HOST_CATS:
            host.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
    dev.sort(key=lambda r: r[2])
    return dev, host


def busy_us(device_events: list) -> float:
    """Microseconds in which at least one operation ran on the device."""
    total, end = 0.0, -np.inf
    for _, _, t0, dur in sorted(device_events, key=lambda r: r[2]):
        t1 = t0 + dur
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total


def idle_gaps(device_events: list, t0_us: float, t1_us: float) -> list:
    """(start_us, length_us) of each stretch of [t0, t1] with nothing on the device."""
    gaps, end = [], t0_us
    for _, _, s, dur in sorted(device_events, key=lambda r: r[2]):
        if s > end:
            gaps.append((end, s - end))
        end = max(end, s + dur)
    if t1_us > end:
        gaps.append((end, t1_us - end))
    return gaps


def breakdown(device_events: list, host_events: list, t0_us: float, t1_us: float,
              top: int = 10, labelled: int = 400) -> dict:
    """The device operations that took most time, and the idle time of the
    ``labelled`` longest gaps by the innermost host event at each gap's middle."""
    by_name: dict = {}
    for _, name, _, dur in device_events:
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(device_events, t0_us, t1_us), key=lambda g: -g[1])[:labelled]
    host_events = [h for h in host_events if h[0] != WINDOW]
    names = [h[0] for h in host_events]
    starts = np.asarray([h[1] for h in host_events], np.float64)
    ends = starts + np.asarray([h[2] for h in host_events], np.float64)
    by_host: dict = {}
    for s, length in gaps:
        mid = s + length / 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        label = ("host: " + names[inside[np.argmin(ends[inside] - starts[inside])]]
                 if len(inside) else "host: no torch operation (Python, numpy)")
        by_host[label] = by_host.get(label, 0.0) + length * 1e-6
    gap_list = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in gap_list]}
