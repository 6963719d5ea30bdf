"""RemoteTreeParallelPlan: tree shards on worker *processes*, partials on
the wire.

The paper's uint32 partial accumulators are associative, so the
tree-parallel merge is transport-agnostic — ``tree_parallel`` shows it
across threads; this plan shows it across processes and hosts.  The forest
is carved into tree-contiguous shards (``ForestIR.subset``), each
dispatched as a PREDICT frame to a worker over the compact length-prefixed
protocol in :mod:`repro_torch.serve.wire` (the JAX package's frames, byte
for byte), and the returned raw uint32 buffers merge at the gateway
bit-identically to the single-process walk, finalized once through the
base plan's ``finalize_partials`` path.

Fleet semantics:

* **Heterogeneous pool** — like ``tree_parallel``, ``backend`` may be a
  sequence of names cycled over shards (``cuda|bitvector``: K1 shards next
  to K5 shards); each worker builds whatever backend its shard table entry
  names, on its own device.
* **Straggler/death policy** — every dispatch carries a deadline
  (``deadline_ms``; ``None`` disables).  A timeout, EOF, or socket error
  marks that connection dead (its socket is closed, so a late straggler
  response can never be confused with a live request) and the shard is
  re-dispatched to the next healthy connection — the HELLO shard table
  named every shard to every worker, so re-dispatch needs no
  re-handshake.  A worker-side MSG_ERROR (e.g. a worker started on a card
  its host does not have) fails the *attempt* but keeps the connection.
* **Workers** — ``workers=N`` (or ``None``) spawns N loopback worker
  processes on the plan's device, owned by the plan (terminated on
  ``close()``; an ``atexit`` net catches leaked plans);
  ``workers=["host:port", ...]`` (or a comma-joined string) connects to an
  existing fleet, each worker on the device it was started on.
* **Tracing** — each dispatch runs under a ``shard:w<idx>:...`` span, and
  the worker's own decode/build/predict spans (shipped home in the
  PARTIALS trailer as request-relative ns offsets) are grafted under it as
  ``worker:*`` children, so a request trace shows wall time *inside* the
  remote process.

Connect + handshake cost is recorded once under the ``"remote"`` key of
the engine's compile/warm ledger (via ``drain_setup_timings``), landing in
``compile_ms_by_bucket`` next to the bucket builds and the autotuner's
``"tune"`` entry.
"""
from __future__ import annotations

import atexit
import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import reduce
from itertools import cycle, islice
from typing import Optional

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.ir.forest_ir import refuse_margins
from repro_torch.plan.base import ExecutionPlan, as_ir, register_plan
from repro_torch.plan.tree_parallel import tree_ranges
from repro_torch.serve import wire

_DEFAULT_WORKERS = 2
_DEFAULT_DEADLINE_MS = 30000.0


class WorkerError(RuntimeError):
    """The worker answered MSG_ERROR: this attempt failed, the connection
    is still healthy (do not evict)."""


class _WorkerConn:
    """One gateway-side connection: serialized request/response framing."""

    def __init__(self, idx: int, addr: str, proc=None):
        self.idx = idx
        self.addr = addr
        self.proc = proc  # owned subprocess (loopback spawn) or None
        self.sock: Optional[socket.socket] = None
        self.info: dict = {}
        self.alive = False
        self._req = 0
        self._lock = threading.Lock()

    def connect(self, hello: bytes, *, timeout_s: float) -> None:
        host, _, port = self.addr.rpartition(":")
        self.sock = socket.create_connection((host, int(port)),
                                             timeout=timeout_s)
        wire.send_frame(self.sock, wire.MSG_HELLO, hello)
        msg_type, payload = wire.read_frame(self.sock)
        if msg_type != wire.MSG_HELLO_ACK:
            raise ConnectionError(
                f"worker {self.addr}: expected HELLO_ACK, got {msg_type}")
        self.info = json.loads(payload)
        self.alive = True

    def call(self, shard_id: int, X, deadline_s: Optional[float]):
        """One PREDICT round-trip -> (uint32 partials, worker spans).
        Raises OSError/ConnectionError on death or deadline (evict),
        WorkerError on a reported failure (keep)."""
        with self._lock:
            if not self.alive:
                raise ConnectionError(f"worker {self.addr} is dead")
            self._req += 1
            rid = self._req
            self.sock.settimeout(deadline_s)
            wire.send_frame(self.sock, wire.MSG_PREDICT,
                            wire.encode_predict(rid, shard_id, X))
            msg_type, payload = wire.read_frame(self.sock)
            if msg_type == wire.MSG_ERROR:
                _, err = wire.decode_error(payload)
                raise WorkerError(f"worker {self.addr}: {err}")
            if msg_type != wire.MSG_PARTIALS:
                raise ConnectionError(
                    f"worker {self.addr}: unexpected frame {msg_type}")
            got_rid, got_shard, acc, spans = wire.decode_partials(payload)
            if got_rid != rid or got_shard != shard_id:
                raise ConnectionError(
                    f"worker {self.addr}: out-of-sync response "
                    f"(req {got_rid}/{rid}, shard {got_shard}/{shard_id})")
            return acc, spans

    def mark_dead(self) -> None:
        """Evict: close the socket so a late straggler response can never be
        read as the reply to a future request."""
        self.alive = False
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass

    def close(self) -> None:
        if self.sock is not None and self.alive:
            try:
                wire.send_frame(self.sock, wire.MSG_CLOSE)
            except OSError:
                pass
        self.mark_dead()
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except Exception:
                self.proc.kill()
            self.proc = None


@register_plan
class RemoteTreeParallelPlan(ExecutionPlan):
    name = "remote_tree_parallel"
    deterministic_only = True

    def __init__(self, model, *, mode: str = "integer", backend="reference",
                 shards=None, layout: Optional[str] = None,
                 backend_kwargs: Optional[dict] = None, device=None,
                 workers=None, deadline_ms: Optional[float] = _DEFAULT_DEADLINE_MS,
                 connect_timeout_s: float = 60.0, retries: Optional[int] = None,
                 span_dir=None, model_id: str = "model", version: int = 0):
        ir = as_ir(model)
        # the wire's HELLO carries no classes or base
        refuse_margins(ir, f"plan {self.name!r}")
        super().__init__(ir, mode=mode)
        if not self._spec.deterministic:
            raise ValueError(
                f"remote_tree_parallel ships exact integer partials; mode "
                f"{mode!r} accumulates floats — use row_parallel locally"
            )
        self.ir = ir
        self.device = resolve_device(device)
        self.deadline_ms = deadline_ms
        self._retries = retries
        self._closed = False
        self._redispatches = 0

        t_setup = time.perf_counter()
        # -- worker pool: spawn loopback processes or connect to a fleet
        self._procs = []
        if workers is None or isinstance(workers, int):
            from repro_torch.serve.worker import spawn_local_workers

            n = int(workers) if workers else int(shards or _DEFAULT_WORKERS)
            self._procs, addrs = spawn_local_workers(n, span_dir=span_dir,
                                                     device=str(self.device))
        else:
            if isinstance(workers, str):
                workers = [w.strip() for w in workers.split(",") if w.strip()]
            addrs = list(workers)
        if not addrs:
            raise ValueError("remote_tree_parallel needs at least one worker")

        # -- shard table: like tree_parallel, heterogeneous names cycle
        if isinstance(backend, str):
            names = [backend] * int(shards or len(addrs))
        else:
            names = list(islice(cycle(backend), int(shards or len(backend))))
        if not names:
            raise ValueError("remote_tree_parallel needs at least one shard")
        self.ranges = tree_ranges(ir.n_trees, len(names))
        self._names = names[: len(self.ranges)]
        shard_table = [
            {"shard": i, "start": a, "stop": b, "backend": name,
             "layout": layout, "backend_kwargs": backend_kwargs}
            for i, (name, (a, b)) in enumerate(zip(self._names, self.ranges))
        ]

        # -- one HELLO payload, sent on every connection
        from repro_torch.serve.spec import EngineSpec

        spec = EngineSpec(mode=mode,
                          backend=backend if isinstance(backend, str)
                          else tuple(backend),
                          layout=layout, plan=self.name,
                          shards=len(self.ranges),
                          backend_kwargs=backend_kwargs)
        meta = {"wire": wire.WIRE_VERSION, "model_id": model_id,
                "version": int(version), "mode": mode,
                "spec": spec.to_dict(), "shards": shard_table,
                "n_trees": int(ir.n_trees), "n_classes": int(ir.n_classes),
                "n_features": int(ir.n_features),
                "quant_scale": int(ir.scale)}
        itrf_bytes = getattr(ir, "itrf_bytes", None)
        wire_arrays = (ir.feature, ir.threshold, ir.threshold_key, ir.left,
                       ir.right, ir.leaf_fixed, ir.node_offsets,
                       ir.tree_depths)
        if itrf_bytes is not None \
                and itrf_bytes.nbytes <= sum(a.nbytes for a in wire_arrays):
            # artifact fast path: the model came from an ITRF file, so HELLO
            # ships the raw artifact image verbatim — no per-array encode or
            # JSON directory on the send side, and the worker rebuilds the
            # IR through the binary reader (zero-copy views over the
            # payload).  Guarded by size so a float-bearing artifact (whose
            # image carries the float64 leaf table the wire deliberately
            # omits) falls back to the explicit array payload.
            meta["artifact_format"] = "itrf"
            hello = wire.encode_hello(meta, {"itrf": itrf_bytes})
            self.hello_format = "itrf"
        else:
            self.hello_format = "arrays"
            hello = wire.encode_hello(meta, {
                "feature": ir.feature, "threshold": ir.threshold,
                "threshold_key": ir.threshold_key, "left": ir.left,
                "right": ir.right, "leaf_fixed": ir.leaf_fixed,
                "node_offsets": ir.node_offsets, "tree_depths": ir.tree_depths,
            })

        self._conns = []
        try:
            for i, addr in enumerate(addrs):
                proc = self._procs[i] if i < len(self._procs) else None
                conn = _WorkerConn(i, addr, proc)
                conn.connect(hello, timeout_s=connect_timeout_s)
                for key in ("model", "version"):
                    if conn.info.get(key) != meta[
                            "model_id" if key == "model" else key]:
                        raise ConnectionError(
                            f"worker {addr} acked {key}="
                            f"{conn.info.get(key)!r}, wanted "
                            f"{meta['model_id' if key == 'model' else key]!r}")
                self._conns.append(conn)
        except Exception:
            self._teardown()
            raise
        self._setup_ms = {"remote": (time.perf_counter() - t_setup) * 1e3}
        self._pool = ThreadPoolExecutor(max_workers=len(self.ranges),
                                        thread_name_prefix="remote-shard")
        atexit.register(self._teardown)  # net for plans never close()d

    # ------------------------------------------------------------ execution
    def predict_partials(self, X):
        if self._closed:
            raise RuntimeError("remote_tree_parallel plan is closed")
        X = np.ascontiguousarray(np.asarray(X, np.float32))
        parent = self.trace_parent
        futs = [self._pool.submit(self._dispatch_shard, i, X, parent)
                for i in range(len(self.ranges))]
        partials = [np.asarray(f.result()) for f in futs]
        t0 = time.perf_counter_ns()
        merged = reduce(np.add, partials)
        t1 = time.perf_counter_ns()
        self._record_stage("merge", (t1 - t0) / 1e6)
        self._span("merge", t0, t1, parent, shards=len(partials))
        return merged

    def _dispatch_shard(self, i: int, X, parent):
        """Run shard ``i`` on its primary connection, re-dispatching to the
        next healthy one on death/deadline (the straggler policy: a worker
        past its deadline is treated exactly like a dead one)."""
        a, b = self.ranges[i]
        n = len(self._conns)
        order = [self._conns[(i + off) % n] for off in range(n)]
        max_attempts = 1 + (self._retries if self._retries is not None
                            else n - 1)
        deadline_s = (self.deadline_ms / 1e3) if self.deadline_ms else None
        attempts, last_err = 0, None
        for conn in order:
            if attempts >= max_attempts:
                break
            if not conn.alive:
                continue
            attempts += 1
            label = f"w{conn.idx}:{self._names[i]}[{a}:{b}]"
            span = None
            if parent and self._tracer is not None:
                span = self._tracer.child(parent, f"shard:{label}",
                                          worker=conn.addr, shard=i)
            t0 = time.perf_counter_ns()
            try:
                acc, wspans = conn.call(i, X, deadline_s)
            except WorkerError as exc:  # attempt failed; worker stays
                last_err = exc
                if span:
                    span.end(error=str(exc))
                continue
            except (ConnectionError, OSError) as exc:  # dead or straggling
                last_err = exc
                conn.mark_dead()
                with self._timings_lock:
                    self._redispatches += 1
                if span:
                    span.end(error=type(exc).__name__, evicted=True)
                continue
            t1 = time.perf_counter_ns()
            self._record(label, (t1 - t0) / 1e6)
            if span:
                # graft the worker's request-relative spans under the
                # dispatch span, anchored at dispatch start: worker wall
                # time is contained in the round-trip by construction
                for name, r0, r1 in wspans:
                    self._tracer.record(f"worker:{name}", t0 + int(r0),
                                        t0 + int(r1), parent=span)
                span.end(rows=int(X.shape[0]), attempts=attempts)
            return acc
        raise RuntimeError(
            f"shard {i} trees[{a}:{b}]: no worker served it after "
            f"{attempts} attempt(s); last error: {last_err!r}")

    # -------------------------------------------------------------- metadata
    @property
    def backends(self) -> tuple:
        return ()  # executors live in other processes

    @property
    def packed(self):
        return self.ir

    @property
    def n_shards(self) -> int:
        return len(self.ranges)

    @property
    def layout(self) -> str:
        from repro_torch.backends import backend_class

        layouts = []
        for name in self._names:
            lay = backend_class(name).capabilities.preferred_layout
            if lay not in layouts:
                layouts.append(lay)
        return "+".join(layouts) if layouts else "padded"

    @property
    def backend_name(self) -> str:
        names = []
        for name in self._names:
            if name not in names:
                names.append(name)
        return "+".join(names)

    @property
    def compiles_per_shape(self) -> bool:
        # worker-side backends pick their kernels per batch shape exactly as
        # they would in-process, so the engine's shape bucketing still holds
        from repro_torch.backends import backend_class

        return any(backend_class(n).capabilities.compiles_per_shape
                   for n in self._names)

    @property
    def preferred_block_rows(self) -> Optional[int]:
        from repro_torch.backends import backend_class

        hints = [backend_class(n).capabilities.preferred_block_rows
                 for n in self._names]
        hints = [h for h in hints if h]
        return max(hints) if hints else None

    @property
    def redispatches(self) -> int:
        """Shard attempts re-routed after a death/deadline eviction."""
        return self._redispatches

    def workers(self) -> list:
        return [{"idx": c.idx, "addr": c.addr, "alive": c.alive,
                 "pid": c.info.get("pid"), "device": c.info.get("device")}
                for c in self._conns]

    def describe(self) -> dict:
        d = super().describe()
        d.update(shards=self.n_shards, tree_ranges=self.ranges,
                 backends=list(self._names), workers=self.workers(),
                 redispatches=self._redispatches, hello=self.hello_format)
        return d

    def drain_setup_timings(self) -> dict:
        out, self._setup_ms = self._setup_ms, {}
        return out

    # -------------------------------------------------------------- lifecycle
    def _teardown(self) -> None:
        for conn in getattr(self, "_conns", ()):
            conn.close()
        for proc in self._procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except Exception:
                    proc.kill()
            if proc.stdout is not None:
                proc.stdout.close()
        self._procs = []

    def close(self) -> None:
        """Drain in-flight dispatches, close worker connections, terminate
        owned worker processes."""
        if self._closed:
            return
        self._closed = True
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
        self._teardown()
        atexit.unregister(self._teardown)
