"""Staged request tracing: nested spans through the serving path.

One request through the gateway touches half a dozen subsystems — admission,
cache probe, micro-batch queue, bucket padding, per-shard execution, partial
merge, finalize, response stitch — and a latency percentile alone cannot say
which of them a slow request paid for.  The tracer records that path as a
tree of **spans**: ``(trace_id, span_id, parent_id, name, t0_ns, t1_ns,
attrs)``, timed with ``perf_counter_ns`` and kept in a bounded thread-safe
ring buffer, exported as JSONL or a flame-style summary (``repro_torch.obs.
export``).

Design constraints, in order:

  * **Near-zero cost when disabled.**  A disabled tracer answers every
    ``request_span``/``child`` call with the module-level :data:`NULL_SPAN`
    singleton — falsy, allocation-free, and every method a no-op — so the
    serving hot path can call the span API unconditionally.  Children of a
    null span are null, so one root-level check gates an entire request's
    tracing.
  * **Sampling at the root.**  ``sample=0.25`` traces every 4th request via
    a deterministic accumulator (no RNG in the hot path); an unsampled
    request's whole span tree collapses to null spans.
  * **Cross-thread spans.**  Spans carry no thread-local magic: the parent
    is passed explicitly, so a span started on the event loop can parent
    spans recorded from the batcher worker, the plan's shard pool, or a
    ctypes call — :meth:`Tracer.record` takes explicit ``t0_ns``/``t1_ns``
    for stages measured where the tracer isn't reachable.
  * **Batch fan-in.**  A micro-batched execute serves many requests at
    once; the batch span is parented to its first sampled rider and lists
    every rider span id in ``attrs["riders"]``, so the export layer can
    graft the shared execution subtree under *each* request that rode it.

Beside the tracer, :func:`profiled` names the serving path's stages in a
``torch.profiler`` trace, on the profiler's own clock: while a profiler
records, each stage runs inside a range (``gateway.*``, ``batcher.*``,
``engine.pad``, ``plan.*``, ``backend.*``), so the device trace can say what
the host was doing while the card waited.  With no profiler recording it
hands out :data:`NULL_SPAN` and enters nothing.  :class:`stage` times a
block into a stage sample, a span and a range at once.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _torch_profiler

__all__ = ["Span", "Tracer", "NULL_SPAN", "NULL_TRACER", "profiled", "stage"]


class Span:
    """One timed, named node of a trace tree.  Created by a :class:`Tracer`;
    call :meth:`end` (or use as a context manager) to stamp the end time and
    commit it to the tracer's ring buffer."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "t0", "t1", "attrs")

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 span_id: int, parent_id: int, t0_ns: int, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0_ns
        self.t1: Optional[int] = None
        self.attrs = attrs

    # ------------------------------------------------------------ lifecycle
    def child(self, name: str, **attrs) -> "Span":
        return self._tracer.child(self, name, **attrs)

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self, **attrs) -> None:
        """Stamp the end time and commit; idempotent (first end wins)."""
        if self.t1 is None:
            self.t1 = time.perf_counter_ns()
            if attrs:
                self.attrs.update(attrs)
            self._tracer._push(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    # -------------------------------------------------------------- reading
    @property
    def duration_ms(self) -> float:
        return ((self.t1 if self.t1 is not None else time.perf_counter_ns())
                - self.t0) / 1e6

    def to_dict(self) -> dict:
        return {
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "t0_us": self.t0 / 1e3,
            "dur_us": (((self.t1 or self.t0) - self.t0) / 1e3),
            "attrs": self.attrs,
        }

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"span={self.span_id}, parent={self.parent_id})")


class _NullSpan:
    """The falsy do-nothing span: what a disabled/unsampled trace hands out.
    Every operation is a no-op returning null, so a whole request's span
    tree costs a few method calls and zero allocations."""

    __slots__ = ()
    name = "null"
    trace_id = span_id = parent_id = 0
    t0 = t1 = 0
    attrs: dict = {}
    duration_ms = 0.0

    def __bool__(self) -> bool:
        return False

    def child(self, name: str, **attrs) -> "_NullSpan":
        return self

    def annotate(self, **attrs) -> None:
        pass

    def end(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


def profiled(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler records,
    else :data:`NULL_SPAN`.  Use as ``with profiled("plan.finalize"): ...``.

    The check is one read of torch's module flag, so a site costs an
    attribute read and a no-op ``with`` when nothing records.  The range is
    torch's ``_RecordFunctionFast``, which holds the interpreter lock from
    its entry to its exit (``record_function`` hands it over at each, which
    stretches every other thread's stages) and lands in the trace as a
    ``cpu_op`` event.  A profiler keeps the ranges of the threads it records:
    by default the thread that started it, where on any other thread the
    range is one check in C; every thread with ``profile_all_threads`` in its
    ``torch._C._profiler._ExperimentalConfig``.  Never hold a range across an
    ``await``: it would interleave with other coroutines' ranges on the
    event loop's thread."""
    if _torch_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return NULL_SPAN


class stage:
    """Times a block as one serving stage: a :func:`profiled` range named
    ``range_name``, ``record(key, ms)`` with the block's wall milliseconds,
    and, when ``parent`` is a live span, the span ``span`` (``key`` if not
    given) committed under it through ``tracer.record`` with ``attrs``.  Set
    attributes known only once the block has run on ``.attrs`` inside it.  A
    block that raises records no sample and no span.

        with stage("plan.finalize", self._record_stage, "finalize",
                   self._tracer, self.trace_parent):
            out = finalize_partials(...)
    """

    __slots__ = ("_range", "_record", "_key", "_tracer", "_parent", "_span",
                 "attrs", "_t0")

    def __init__(self, range_name: str, record, key: str, tracer=None,
                 parent=None, span: Optional[str] = None, **attrs):
        self._range = profiled(range_name)
        self._record = record
        self._key = key
        self._tracer = tracer
        self._parent = parent
        self._span = span or key
        self.attrs = attrs

    def __enter__(self) -> "stage":
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        if exc_type is None:
            self._record(self._key, (t1 - self._t0) / 1e6)
            if self._parent and self._tracer is not None:
                self._tracer.record(self._span, self._t0, t1,
                                    parent=self._parent, **self.attrs)
        self._range.__exit__(exc_type, exc, tb)
        return False


class Tracer:
    """Span factory + bounded ring buffer of completed spans.

    ``capacity`` bounds memory (oldest spans are dropped — ``dropped``
    counts them); ``sample`` in [0, 1] picks which *requests* are traced
    (children inherit the decision through null-span propagation);
    ``enabled=False`` turns the whole tracer into null-span handouts.
    """

    def __init__(self, *, capacity: int = 16384, sample: float = 1.0,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self.sample = float(sample)
        self.capacity = int(capacity)
        self._buf: list = []
        self._lock = threading.Lock()
        self._next_id = 1
        self._acc = 0.0  # deterministic sampling accumulator
        self.started = 0  # root spans handed out (sampled)
        self.dropped = 0  # completed spans evicted by the ring bound

    # --------------------------------------------------------- span creation
    def _ids(self, n: int = 1) -> int:
        with self._lock:
            first = self._next_id
            self._next_id += n
            return first

    def request_span(self, name: str, **attrs):
        """Start a root span for one request; returns :data:`NULL_SPAN` when
        disabled or when the sampler skips this request."""
        if not self.enabled:
            return NULL_SPAN
        with self._lock:
            self._acc += self.sample
            if self._acc < 1.0:
                return NULL_SPAN
            self._acc -= 1.0
            tid = self._next_id
            self._next_id += 2
            self.started += 1
        return Span(self, name, tid, tid + 1, 0, time.perf_counter_ns(), attrs)

    def child(self, parent, name: str, **attrs):
        """Start a span under ``parent`` (null/None parent -> null child)."""
        if not parent:
            return NULL_SPAN
        sid = self._ids()
        return Span(self, name, parent.trace_id, sid, parent.span_id,
                    time.perf_counter_ns(), attrs)

    def record(self, name: str, t0_ns: int, t1_ns: int, *, parent, **attrs):
        """Commit an already-measured span under ``parent`` — for stages
        timed with raw ``perf_counter_ns`` deep in the execution path."""
        if not parent:
            return
        sid = self._ids()
        s = Span(self, name, parent.trace_id, sid, parent.span_id,
                 int(t0_ns), attrs)
        s.t1 = int(t1_ns)
        self._push(s)

    # ------------------------------------------------------------ the buffer
    def _push(self, span: Span) -> None:
        with self._lock:
            self._buf.append(span)
            if len(self._buf) > self.capacity:
                # drop the oldest half in one slice: amortized O(1) per push
                excess = len(self._buf) - self.capacity // 2
                del self._buf[:excess]
                self.dropped += excess

    def spans(self) -> list:
        """A snapshot of the completed spans currently buffered."""
        with self._lock:
            return list(self._buf)

    def drain(self) -> list:
        """Remove and return every buffered span (for incremental export)."""
        with self._lock:
            out, self._buf = self._buf, []
        return out

    def __len__(self) -> int:
        return len(self._buf)


# the shared disabled tracer: what serving components fall back to when no
# tracer is attached, so the span API is always callable
NULL_TRACER = Tracer(capacity=1, enabled=False)
