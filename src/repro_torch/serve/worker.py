"""Remote shard worker: one process serving uint32 partials over the wire.

``python -m repro_torch.serve.worker --listen 0.0.0.0:7411`` turns any host
into a shard worker on its card (``--device cuda``, the default) or, when
asked, on the CPU (``--device cpu``).  The gateway's
``remote_tree_parallel`` plan connects, sends one HELLO carrying the
ForestIR arrays (or the raw ITRF image) + the shard table, and then streams
PREDICT frames; the worker answers each with the raw uint32 partial
accumulator of the requested tree shard (see :mod:`repro_torch.serve.wire`
for the frame layout, which is the JAX package's byte for byte).

Design points that make the failure story simple:

* Session state is **per connection** — HELLO installs the forest and the
  shard table for that connection only, so one worker can serve several
  gateways (or several models) at once and a reconnect is a fresh
  handshake, never a stale-model hazard.
* Shard backends build **lazily on first use**, through
  ``plan.base.build_backend`` on the worker's device: the shard table names
  every shard, so *any* worker can serve *any* shard, and re-dispatching a
  dead worker's shard to a healthy one needs no re-handshake.
* A worker never serves from another device than its own: a worker started
  on ``cuda`` on a host without a card fails each attempt with an ERROR
  frame naming the device.
* ``--delay-ms`` injects a fixed response delay (a deliberate straggler for
  deadline and re-dispatch tests); ``--span-out`` appends each request's
  worker-side spans as JSONL (the same spans ride home in the PARTIALS
  trailer and are grafted into the gateway trace), with the kernel launches
  (``kernels.tree_traverse.LAUNCHES``) counted in this process since the
  record before, under ``launches``, since a gateway's counters cannot see
  another process's kernels.

Imports stay stdlib+numpy at module level so ``WORKER_READY host:port``
prints before torch loads — spawners block on that line; torch and the
backends then load on a thread while the gateway connects.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time

import numpy as np

from repro_torch.serve import wire

__all__ = ["WorkerServer", "spawn_local_workers", "main"]


def _preload() -> None:
    """Import what a session needs (torch, the IR, the plans and backends),
    on a thread at start, so the first HELLO finds them loaded."""
    import repro_torch.ir.artifact  # noqa: F401
    import repro_torch.plan  # noqa: F401


class _Session:
    """Per-connection model state installed by HELLO."""

    def __init__(self, payload, device: str):
        meta, arrays = wire.decode_hello(payload)
        from repro_torch.ir import ForestIR

        if meta.get("artifact_format") == "itrf":
            # artifact fast path: the payload carries a raw ITRF image —
            # rebuild the forest through the binary reader (views over the
            # received bytes) instead of the per-array directory
            from repro_torch.ir.artifact import read_itrf_bytes

            self.ir = read_itrf_bytes(arrays["itrf"].tobytes())
        else:
            total = int(arrays["feature"].shape[0])
            n_classes = int(meta["n_classes"])
            self.ir = ForestIR(
                feature=arrays["feature"].astype(np.int32),
                threshold=arrays["threshold"].astype(np.float32),
                threshold_key=arrays["threshold_key"].astype(np.int32),
                left=arrays["left"].astype(np.int32),
                right=arrays["right"].astype(np.int32),
                # deterministic modes never read float leaf probabilities —
                # the one big float64 table stays off the wire (see wire.py)
                leaf_probs=np.zeros((total, n_classes), np.float64),
                leaf_fixed=arrays["leaf_fixed"].astype(np.uint32),
                node_offsets=arrays["node_offsets"].astype(np.int64),
                tree_depths=arrays["tree_depths"].astype(np.int32),
                n_trees=int(meta["n_trees"]),
                n_classes=n_classes,
                n_features=int(meta["n_features"]),
                quant_scale=int(meta["quant_scale"]),
            )
        self.meta = meta
        self.device = device
        self.mode = str(meta["mode"])
        self.shard_table = {int(s["shard"]): s for s in meta["shards"]}
        self._backends: dict = {}
        self._lock = threading.Lock()

    def backend(self, shard_id: int):
        """-> (backend, built_now) for ``shard_id``, building lazily."""
        with self._lock:
            hit = self._backends.get(shard_id)
            if hit is not None:
                return hit, False
            spec = self.shard_table.get(shard_id)
            if spec is None:
                raise KeyError(f"shard {shard_id} not in shard table "
                               f"{sorted(self.shard_table)}")
            from repro_torch.plan.base import build_backend

            sub = self.ir.subset(int(spec["start"]), int(spec["stop"]))
            b = build_backend(spec["backend"], sub, self.mode,
                              spec.get("layout"), spec.get("backend_kwargs"),
                              device=self.device)
            self._backends[shard_id] = b
            return b, True


class WorkerServer:
    """Accept loop + one thread per gateway connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 span_out=None, delay_ms: float = 0.0, device: str = "cuda"):
        self.delay_ms = float(delay_ms)
        self.device = str(device)
        self._sock = socket.create_server((host, port))
        addr = self._sock.getsockname()
        self.host, self.port = addr[0], addr[1]
        self._span_fh = open(span_out, "a") if span_out else None
        self._span_lock = threading.Lock()
        self._launches_seen: dict = {}
        self._closed = False

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def serve_forever(self) -> None:
        while not self._closed:
            try:
                conn, _peer = self._sock.accept()
            except OSError:  # listener closed
                break
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        finally:
            if self._span_fh is not None:
                self._span_fh.close()
                self._span_fh = None

    # -- per-connection protocol loop -------------------------------------

    def _handle(self, conn: socket.socket) -> None:
        session = None
        try:
            while True:
                try:
                    msg_type, payload = wire.read_frame(conn)
                except wire.ConnectionClosed:
                    break
                if msg_type == wire.MSG_HELLO:
                    session = _Session(payload, self.device)
                    ack = {"pid": os.getpid(), "host": socket.gethostname(),
                           "wire": wire.WIRE_VERSION,
                           "model": session.meta.get("model_id"),
                           "version": session.meta.get("version"),
                           "device": self.device}
                    wire.send_frame(conn, wire.MSG_HELLO_ACK,
                                    json.dumps(ack).encode())
                elif msg_type == wire.MSG_PREDICT:
                    self._predict(conn, session, payload)
                elif msg_type == wire.MSG_CLOSE:
                    break
                else:
                    wire.send_frame(conn, wire.MSG_ERROR,
                                    wire.encode_error(0, f"bad msg {msg_type}"))
        except (ConnectionError, OSError):
            pass  # gateway vanished; nothing to tell it
        finally:
            conn.close()

    def _predict(self, conn, session, payload) -> None:
        t_recv = time.perf_counter_ns()
        req_id, shard_id, X = wire.decode_predict(payload)
        spans = [("decode", 0, time.perf_counter_ns() - t_recv)]
        if session is None:
            wire.send_frame(conn, wire.MSG_ERROR,
                            wire.encode_error(req_id, "PREDICT before HELLO"))
            return
        try:
            t0 = time.perf_counter_ns()
            backend, built = session.backend(shard_id)
            t1 = time.perf_counter_ns()
            if built:
                spans.append(("build", t0 - t_recv, t1 - t_recv))
            acc = np.asarray(backend.predict_partials(X), np.uint32)
            spans.append(("predict", t1 - t_recv,
                          time.perf_counter_ns() - t_recv))
        except Exception as exc:  # report, keep the connection alive
            wire.send_frame(conn, wire.MSG_ERROR, wire.encode_error(
                req_id, f"worker on device {self.device}: {exc!r}"))
            return
        if self.delay_ms:  # injected straggle, after the real work
            time.sleep(self.delay_ms / 1e3)
        wire.send_frame(conn, wire.MSG_PARTIALS,
                        wire.encode_partials(req_id, shard_id, acc, spans))
        self._log_spans(session, req_id, shard_id, len(X), spans)

    def _log_spans(self, session, req_id, shard_id, rows, spans) -> None:
        if self._span_fh is None:
            return
        from repro_torch.kernels.tree_traverse import LAUNCHES

        rec = {"worker_pid": os.getpid(), "device": self.device,
               "model": session.meta.get("model_id"),
               "version": session.meta.get("version"),
               "req": int(req_id), "shard": int(shard_id), "rows": int(rows),
               "spans": [{"name": n, "t0_rel_us": a / 1e3,
                          "dur_us": (b - a) / 1e3} for n, a, b in spans]}
        with self._span_lock:
            now = dict(LAUNCHES)
            rec["launches"] = {k: v - self._launches_seen.get(k, 0)
                               for k, v in now.items()}
            self._launches_seen = now
            self._span_fh.write(json.dumps(rec) + "\n")
            self._span_fh.flush()


# ---------------------------------------------------------------------------
# local spawning (tests, chip_smoke.py, workers=N)
# ---------------------------------------------------------------------------

def spawn_local_workers(n: int, *, delays=None, span_dir=None, device=None,
                        ready_timeout_s: float = 60.0):
    """Spawn ``n`` loopback worker processes on ``device`` (``cuda`` unless
    ``device="cpu"`` is passed); -> (procs, ["host:port"]).

    Each worker prints ``WORKER_READY host:port`` once its listener is
    bound; this blocks until every line arrives (the workers load torch
    after that line, while the gateway connects).  ``delays[i]`` ms makes
    worker *i* a deliberate straggler.  Span JSONL files land in
    ``span_dir`` (default: ``$REPRO_WORKER_SPAN_DIR``).
    """
    import subprocess

    if span_dir is None:
        span_dir = os.environ.get("REPRO_WORKER_SPAN_DIR")
    device = "cuda" if device is None else str(device)
    src_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs, addrs = [], []
    try:
        for i in range(int(n)):
            cmd = [sys.executable, "-m", "repro_torch.serve.worker",
                   "--listen", "127.0.0.1:0", "--device", device]
            delay = (delays[i] if delays and i < len(delays) else 0) or 0
            if delay:
                cmd += ["--delay-ms", str(delay)]
            if span_dir:
                os.makedirs(span_dir, exist_ok=True)
                cmd += ["--span-out",
                        os.path.join(span_dir, f"worker_{os.getpid()}_{i}.jsonl")]
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.DEVNULL, text=True, env=env)
            procs.append(p)
            deadline = time.monotonic() + ready_timeout_s
            addr = None
            while time.monotonic() < deadline:
                line = p.stdout.readline()
                if not line:
                    raise RuntimeError(
                        f"worker {i} exited before READY (rc={p.poll()})")
                if line.startswith("WORKER_READY"):
                    addr = line.split()[1]
                    break
            if addr is None:
                raise RuntimeError(f"worker {i} READY timeout")
            addrs.append(addr)
    except Exception:
        for p in procs:
            p.kill()
            p.wait()
            if p.stdout is not None:
                p.stdout.close()
        raise
    return procs, addrs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.worker",
        description="repro_torch shard worker: serves uint32 tree-shard "
                    "partials over the ITRG wire protocol")
    ap.add_argument("--listen", default="127.0.0.1:0", metavar="HOST:PORT",
                    help="bind address (port 0 = ephemeral; the bound port "
                         "is printed on the WORKER_READY line)")
    ap.add_argument("--span-out", default=None, metavar="PATH",
                    help="append worker-side request spans as JSONL")
    ap.add_argument("--delay-ms", type=float, default=0.0,
                    help="inject a fixed response delay (straggler testing)")
    ap.add_argument("--device", default="cuda",
                    help="the device the shard backends run on (default "
                         "cuda; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    host, _, port = args.listen.rpartition(":")
    srv = WorkerServer(host or "127.0.0.1", int(port or 0),
                       span_out=args.span_out, delay_ms=args.delay_ms,
                       device=args.device)
    print(f"WORKER_READY {srv.addr}", flush=True)
    threading.Thread(target=_preload, daemon=True).start()
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()


if __name__ == "__main__":
    main()
