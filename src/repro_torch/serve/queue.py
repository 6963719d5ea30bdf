"""Async request queue + micro-batcher.

Turns a stream of independent single-row / small-batch submissions into the
block-shaped batches the kernels want: per model, a worker coalesces queued
requests until either ``max_batch_rows`` rows have accumulated or the oldest
request has waited ``max_delay_ms`` (the latency deadline), then dispatches
one engine call and scatters the per-row results back to each caller's
future.  Row outputs are independent of batch composition (tree traversal is
per-row), so coalescing is bit-transparent to callers.

Admission control: each model queue admits at most ``max_queue_rows`` rows;
beyond that ``submit`` fails fast with :class:`AdmissionError` (the
closed-loop client counts these as rejects) instead of letting latency grow
without bound.

Observability: ``submit`` optionally carries the caller's request span; at
dispatch the worker commits one ``queue`` span per pending request (enqueue →
dispatch, the micro-batching wait) under that parent and reports the same
waits to ``on_queue`` for the per-stage metric histograms.  With
``pass_spans=True`` the executor is called as ``execute(model_id, X,
rider_spans)`` so the gateway can graft the shared batch subtree under every
rider request.  While a ``torch.profiler`` records, the worker's two stretches
of host work between awaits are named ranges: ``batcher.assemble`` (from the
dispatch instant: queue spans, ``on_queue``, the concatenation) and
``batcher.scatter`` (``on_batch`` and the callers' results).
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Callable, Tuple

import numpy as np

from repro_torch.obs import profiled

ExecuteFn = Callable[[str, np.ndarray], Tuple[np.ndarray, np.ndarray, int, object]]


class AdmissionError(RuntimeError):
    """Raised when a model's queue is over its admission bound."""


# queued behind every pending request at close(): the lane worker drains all
# real work ahead of it, then exits cleanly instead of being cancelled
_CLOSE = object()


@dataclass
class _Pending:
    X: np.ndarray
    rows: int
    t_enqueue: float
    future: asyncio.Future = field(compare=False)
    span: object = None  # the caller's request span (None/NULL when untraced)


class MicroBatcher:
    """Per-model dynamic batcher.

    ``execute(model_id, X) -> (scores, preds, padded_rows, meta)`` runs a
    formed batch (in a thread so model workers overlap); it is supplied by
    the gateway so the batcher stays policy-only.  ``meta`` is opaque and
    handed back verbatim to every caller in the batch (the gateway uses it
    to learn which model *version* actually served the batch).  Each
    ``submit`` resolves to ``(scores, preds, meta)`` for exactly its rows.

    ``on_queue(model_id, waits_ms)`` (optional) receives each dispatched
    batch's per-request queue waits; ``tracer`` (a ``repro_torch.obs.Tracer``)
    turns those waits into ``queue`` spans under each request's span; with
    ``pass_spans=True`` the executor is called with a third ``rider_spans``
    argument (the batch's request spans, in batch order).
    """

    def __init__(self, execute: ExecuteFn, *, max_batch_rows: int = 256,
                 max_delay_ms: float = 2.0, max_queue_rows: int = 4096,
                 on_batch: Callable[[str, int, int], None] | None = None,
                 on_queue: Callable[[str, list], None] | None = None,
                 close_timeout_s: float = 30.0,
                 tracer=None, pass_spans: bool = False):
        if max_batch_rows <= 0 or max_queue_rows <= 0:
            raise ValueError("batch and queue bounds must be positive")
        self._execute = execute
        self.max_batch_rows = max_batch_rows
        self.max_delay_s = max_delay_ms / 1e3
        self.max_queue_rows = max_queue_rows
        self.close_timeout_s = close_timeout_s
        self._on_batch = on_batch
        self._on_queue = on_queue
        self._tracer = tracer
        self._pass_spans = pass_spans
        self._queues: dict[str, asyncio.Queue] = {}
        self._queued_rows: dict[str, int] = {}
        self._workers: dict[str, asyncio.Task] = {}
        self._closed = False

    # ------------------------------------------------------------- submit
    def _lane(self, model_id: str) -> asyncio.Queue:
        # (re)spawn the lane if it has no live worker — e.g. the gateway is
        # reused across asyncio.run() calls and the old loop tore it down
        w = self._workers.get(model_id)
        if w is None or w.done():
            self._queues[model_id] = asyncio.Queue()
            self._queued_rows[model_id] = 0
            self._workers[model_id] = asyncio.get_running_loop().create_task(
                self._worker(model_id)
            )
        return self._queues[model_id]

    async def submit(self, model_id: str, X: np.ndarray, span=None):
        """Enqueue rows; resolves to (scores, preds, meta) for those rows.
        ``span`` (optional) is the caller's request span — the queue wait and
        batch execution spans are committed under it."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        X = np.atleast_2d(np.asarray(X, np.float32))
        rows = X.shape[0]
        lane = self._lane(model_id)
        if self._queued_rows[model_id] + rows > self.max_queue_rows:
            raise AdmissionError(
                f"{model_id}: queue depth {self._queued_rows[model_id]}+{rows} "
                f"exceeds {self.max_queue_rows} rows"
            )
        fut = asyncio.get_running_loop().create_future()
        self._queued_rows[model_id] += rows
        lane.put_nowait(_Pending(X=X, rows=rows, t_enqueue=time.perf_counter(),
                                 future=fut, span=span))
        return await fut

    # ------------------------------------------------------------- worker
    async def _worker(self, model_id: str) -> None:
        lane = self._queues[model_id]
        loop = asyncio.get_running_loop()
        carry = None  # request that would have overflowed the previous batch
        closing = False  # close() sentinel seen: finish the drain, then exit
        while True:
            first = carry if carry is not None else await lane.get()
            carry = None
            if first is _CLOSE:  # close() with nothing in flight
                return
            batch = [first]
            rows = first.rows
            deadline = first.t_enqueue + self.max_delay_s
            while rows < self.max_batch_rows:
                # greedy drain: work already queued joins the batch for free
                # (this is what keeps occupancy high once the engine is the
                # bottleneck — the deadline only governs *idle* waiting)
                try:
                    nxt = lane.get_nowait()
                except asyncio.QueueEmpty:
                    if closing:
                        break  # nothing can arrive after the sentinel
                    timeout = deadline - time.perf_counter()
                    if timeout <= 0:
                        break
                    try:
                        nxt = await asyncio.wait_for(lane.get(), timeout)
                    except asyncio.TimeoutError:
                        break
                if nxt is _CLOSE:
                    # everything queued ahead of the sentinel still executes;
                    # this batch (and any carry) is the drain
                    closing = True
                    break
                if rows + nxt.rows > self.max_batch_rows:
                    # never exceed max_batch_rows (warmed buckets stop there);
                    # the overflow request opens the next batch instead
                    carry = nxt
                    break
                batch.append(nxt)
                rows += nxt.rows
            self._queued_rows[model_id] -= rows
            try:
                # the batch's host work up to the executor; no await inside,
                # so the range cannot interleave with other coroutines'
                with profiled("batcher.assemble"):
                    # dispatch instant: every pending request's
                    # micro-batching wait ends here, together — one queue
                    # span per request, one stage sample per request
                    t_dispatch = time.perf_counter()
                    if self._tracer is not None:
                        for p in batch:
                            if p.span:
                                self._tracer.record(
                                    "queue", int(p.t_enqueue * 1e9),
                                    int(t_dispatch * 1e9), parent=p.span, rows=p.rows,
                                )
                    if self._on_queue is not None:
                        try:
                            self._on_queue(
                                model_id,
                                [(t_dispatch - p.t_enqueue) * 1e3 for p in batch],
                            )
                        except Exception:
                            pass  # metrics callbacks must never take down the lane
                    # concatenate inside the try: ragged feature widths from
                    # a misbehaving client must fail its batch, not kill the
                    # worker
                    X = np.concatenate([p.X for p in batch]) if len(batch) > 1 else batch[0].X
                if self._pass_spans:
                    spans = tuple(p.span for p in batch)
                    scores, preds, padded, meta = await loop.run_in_executor(
                        None, self._execute, model_id, X, spans
                    )
                else:
                    scores, preds, padded, meta = await loop.run_in_executor(
                        None, self._execute, model_id, X
                    )
            except asyncio.CancelledError:  # close() mid-batch: don't strand callers
                for p in batch + ([carry] if carry is not None else []):
                    if not p.future.done():
                        p.future.set_exception(RuntimeError("batcher closed"))
                raise
            except Exception as e:  # scatter the failure to every caller
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)
                if closing and carry is None:
                    return
                continue
            with profiled("batcher.scatter"):
                if self._on_batch is not None:
                    try:
                        self._on_batch(model_id, rows, padded)
                    except Exception:
                        pass  # metrics callbacks must never take down the lane
                off = 0
                for p in batch:
                    if not p.future.done():
                        p.future.set_result(
                            (scores[off:off + p.rows], preds[off:off + p.rows], meta)
                        )
                    off += p.rows
            if closing and carry is None:
                return

    def queued_rows(self, model_id: str) -> int:
        return self._queued_rows.get(model_id, 0)

    async def close(self) -> None:
        """Drain, then stop.

        Every request enqueued before this call — including batches already
        executing on the engine — runs to completion and resolves its
        future; a ``_CLOSE`` sentinel queued *behind* the pending work tells
        each lane worker to exit once it has drained past it.  Only if a
        lane overruns ``close_timeout_s`` is it cancelled, and only then are
        its remaining callers failed with "batcher closed".
        """
        self._closed = True  # no await above this line: nothing can sneak in
        live = [t for t in self._workers.values() if not t.done()]
        for model_id, t in self._workers.items():
            if not t.done():
                self._queues[model_id].put_nowait(_CLOSE)
        if live:
            _, stragglers = await asyncio.wait(
                live, timeout=self.close_timeout_s
            )
            for t in stragglers:
                t.cancel()
            for t in stragglers:
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
        # fail anything still queued (only possible on a straggler cancel)
        for model_id, lane in self._queues.items():
            while True:
                try:
                    p = lane.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if p is _CLOSE:
                    continue  # a lane whose worker was already done
                if not p.future.done():
                    p.future.set_exception(RuntimeError("batcher closed"))
            self._queued_rows[model_id] = 0
        self._workers.clear()
