"""The way a request's rows take onto a device and its partials back, for
the backends that key the rows there and launch a hand-written walk
(``cuda``: K1, K2, K3; ``bitvector``: K5).

:func:`partials` checks the rows, moves them to the device, keys them
(FlInt, ``float_to_key``), calls the backend's launch and returns the
uint32 partials to the host.  While a ``torch.profiler`` records, the four
steps are the ranges ``backend.rows_in``, ``backend.keys``,
``backend.launch`` and ``backend.rows_out``.

On a CUDA device every step runs on a stream of the calling thread's own
(:func:`thread_stream`), so one thread's copy, keys and walk never wait in
line behind another's, and the read-back's ``.cpu()`` waits for this
thread's work only.  The rows go through page-locked host memory taken from
torch's caching host allocator (``pin_memory()``) and over with
``non_blocking=True``, so the card's copy engine reads them at the link's
speed instead of the driver staging a pageable copy through its own bounce
buffer.  The allocator records the copy's event on the block and hands the
block out again only once that event has completed, so no later call, not
even one after a call that raised between the copy and the read-back,
rewrites rows that a copy still reads.

The side streams do not order themselves after the legacy default stream, so
a backend's constructor ends with :func:`tables_ready`: the tables it built
are on the card before any thread's stream reads them.  On the CPU the rows
move as they are, with no pinned memory and no stream.

``STAGED`` counts rows copies by path (``pinned``, ``plain``) and the bytes
staged through pinned memory; the backends run on executor threads, so the
counts change under a lock.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core.ensemble import u32_numpy
from repro_torch.core.flint import float_to_key
from repro_torch.obs import profiled

#: rows copies by path, and the bytes staged through pinned memory
STAGED = {"pinned": 0, "plain": 0, "pinned_bytes": 0}
_STAGED_LOCK = threading.Lock()
_THREAD = threading.local()


def reset_staged() -> None:
    """Set every ``STAGED`` count to 0."""
    with _STAGED_LOCK:
        for name in STAGED:
            STAGED[name] = 0


def thread_stream(device) -> torch.cuda.Stream:
    """The calling thread's own stream on the CUDA ``device``, made at the
    thread's first call there."""
    streams = getattr(_THREAD, "streams", None)
    if streams is None:
        streams = _THREAD.streams = {}
    stream = streams.get(device)
    if stream is None:
        stream = streams[device] = torch.cuda.Stream(device)
    return stream


def tables_ready(device) -> None:
    """Wait for every queued operation on a CUDA ``device``: a backend's
    tables, built on the default stream, before a side stream reads them."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rows_in(X: np.ndarray, device) -> torch.Tensor:
    rows = torch.from_numpy(np.ascontiguousarray(X, np.float32))
    if device.type != "cuda":
        with _STAGED_LOCK:
            STAGED["plain"] += 1
        return rows.to(device)
    with _STAGED_LOCK:
        STAGED["pinned"] += 1
        STAGED["pinned_bytes"] += rows.numel() * rows.element_size()
    return rows.pin_memory().to(device, non_blocking=True)


def partials(X, n_features: int, device, launch) -> np.ndarray:
    """(B, F) float rows -> (B, C) uint32 partials on the host: ``launch``
    takes the rows' FlInt keys on ``device`` and returns the partials there
    (as uint32 or their int32 bits).

    Rows must carry at least the forest's ``n_features`` columns: the
    kernels take the row stride from the rows, so fewer columns would read
    the next row, and past the buffer at the last one."""
    X = np.asarray(X)
    if X.ndim != 2 or X.shape[1] < n_features:
        raise ValueError(
            f"rows of shape {X.shape} have fewer columns than the "
            f"{n_features} features the forest reads")
    # torch.cuda.stream(None) enters nothing: the CPU keeps its one order
    stream = thread_stream(device) if device.type == "cuda" else None
    with torch.cuda.stream(stream):
        with profiled("backend.rows_in"):
            x = _rows_in(X, device)
        with profiled("backend.keys"):
            keys = float_to_key(x)
        with profiled("backend.launch"):
            acc = launch(keys)
        with profiled("backend.rows_out"):
            return u32_numpy(acc)
