"""Length-prefixed wire protocol for shipping uint32 partials between hosts.

The fabric's one invariant is the paper's: integer partial accumulators are
associative uint32 sums, so a shard's partial buffer means exactly the same
thing no matter which process produced it.  The protocol is therefore tiny —
raw little-endian array bytes behind a fixed frame header, no serialization
framework:

    frame   := magic(4s=b"ITRG") msg_type(u8) payload_len(u32) payload
    HELLO   := arrays payload (JSON meta + ForestIR CSR arrays): the model
               handshake — model id/version, EngineSpec dict, the shard
               table, and every array a worker needs to rebuild the forest
               (leaf_probs ships as zeros: remote plans are
               deterministic-mode only, and the float leaf table is the one
               big array the uint32 path never reads).  When the gateway's
               model came from an ITRF artifact, ``meta["artifact_format"]
               == "itrf"`` and the single array ``"itrf"`` is the raw
               artifact image — the worker rebuilds the forest through
               ``repro_torch.ir.artifact.read_itrf_bytes`` with no
               per-array directory round-trip (the artifact-bytes fast path)
    HELLO_ACK := JSON {pid, host, wire, model, version}; this package's
               worker adds ``device``, a key the JAX package's plan never
               reads
    PREDICT := u32 req_id, u32 shard_id, u32 rows, u32 features, then
               rows*features little-endian float32
    PARTIALS:= u32 req_id, u32 shard_id, u32 rows, u32 classes, then
               rows*classes little-endian uint32, then a JSON span trailer
               ([name, t0_rel_ns, t1_rel_ns] relative to request receipt,
               grafted into the gateway trace under the dispatch span)
    ERROR   := JSON {req_id, error} — the *attempt* failed (e.g. the worker
               was started on a device its host does not have); the
               connection itself is still healthy
    CLOSE   := empty; polite gateway-side teardown

All integers in frame headers are network byte order (``!``); array bytes
are explicitly little-endian so a big-endian host on either side still
round-trips bit-exactly.  The frames are byte for byte the JAX package's
(``repro.serve.wire``), so a gateway of either package merges the partials
of workers of either package.
"""
from __future__ import annotations

import json
import struct
import socket

import numpy as np

__all__ = [
    "MAGIC", "WIRE_VERSION",
    "MSG_HELLO", "MSG_HELLO_ACK", "MSG_PREDICT", "MSG_PARTIALS",
    "MSG_ERROR", "MSG_CLOSE",
    "ConnectionClosed", "send_frame", "read_frame",
    "pack_arrays", "unpack_arrays",
    "encode_hello", "decode_hello", "encode_predict", "decode_predict",
    "encode_partials", "decode_partials", "encode_error", "decode_error",
]

MAGIC = b"ITRG"
WIRE_VERSION = 1

MSG_HELLO = 1
MSG_HELLO_ACK = 2
MSG_PREDICT = 3
MSG_PARTIALS = 4
MSG_ERROR = 5
MSG_CLOSE = 6

_HEADER = struct.Struct("!4sBI")  # magic, msg_type, payload_len
_U32X4 = struct.Struct("!IIII")
_JLEN = struct.Struct("!I")


class ConnectionClosed(ConnectionError):
    """Peer closed the socket cleanly (EOF at a frame boundary or not)."""


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def send_frame(sock: socket.socket, msg_type: int, payload: bytes = b"") -> None:
    sock.sendall(_HEADER.pack(MAGIC, msg_type, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """``n`` bytes from ``sock``, in a buffer of their own (writable, so a
    PREDICT's rows decode to a writable view with no copy)."""
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionClosed(f"peer closed with {n - got} bytes pending")
        got += k
    return buf


def read_frame(sock: socket.socket) -> tuple:
    """-> (msg_type, payload).  Raises :class:`ConnectionClosed` on EOF."""
    magic, msg_type, n = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if magic != MAGIC:
        raise ConnectionClosed(f"bad frame magic {magic!r}")
    return msg_type, (_recv_exact(sock, n) if n else b"")


# ---------------------------------------------------------------------------
# array payloads (HELLO)
# ---------------------------------------------------------------------------

def _le_bytes(a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a)
    return a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()


def pack_arrays(meta: dict, arrays: dict) -> bytes:
    """JSON header (meta + array directory) followed by the raw
    little-endian bytes of each array, in directory order."""
    entries, blobs = [], []
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        entries.append({"name": name,
                        "dtype": a.dtype.newbyteorder("<").str,
                        "shape": list(a.shape)})
        blobs.append(_le_bytes(a))
    head = json.dumps({"meta": meta, "arrays": entries}).encode()
    return _JLEN.pack(len(head)) + head + b"".join(blobs)


def unpack_arrays(payload: bytes) -> tuple:
    """-> (meta, {name: ndarray}).  Arrays are copies (writable)."""
    (hlen,) = _JLEN.unpack_from(payload)
    head = json.loads(payload[_JLEN.size:_JLEN.size + hlen])
    off = _JLEN.size + hlen
    arrays = {}
    for ent in head["arrays"]:
        dt = np.dtype(ent["dtype"])
        count = int(np.prod(ent["shape"], dtype=np.int64)) if ent["shape"] else 1
        a = np.frombuffer(payload, dt, count=count, offset=off)
        arrays[ent["name"]] = a.reshape(ent["shape"]).copy()
        off += count * dt.itemsize
    return head["meta"], arrays


encode_hello = pack_arrays
decode_hello = unpack_arrays


# ---------------------------------------------------------------------------
# request / response payloads
# ---------------------------------------------------------------------------

def encode_predict(req_id: int, shard_id: int, X) -> bytes:
    X = np.ascontiguousarray(X, np.float32)
    if X.ndim != 2:
        raise ValueError(f"PREDICT wants a 2-D row block, got shape {X.shape}")
    return (_U32X4.pack(req_id, shard_id, X.shape[0], X.shape[1])
            + X.astype("<f4", copy=False).tobytes())


def decode_predict(payload: bytes) -> tuple:
    req_id, shard_id, rows, feats = _U32X4.unpack_from(payload)
    X = np.frombuffer(payload, "<f4", count=rows * feats,
                      offset=_U32X4.size).reshape(rows, feats)
    return req_id, shard_id, X


def encode_partials(req_id: int, shard_id: int, acc, spans=()) -> bytes:
    acc = np.ascontiguousarray(acc, np.uint32)
    if acc.ndim != 2:
        raise ValueError(f"PARTIALS wants (rows, classes), got shape {acc.shape}")
    trailer = json.dumps([[n, int(a), int(b)] for n, a, b in spans]).encode()
    return (_U32X4.pack(req_id, shard_id, acc.shape[0], acc.shape[1])
            + acc.astype("<u4", copy=False).tobytes() + trailer)


def decode_partials(payload: bytes) -> tuple:
    """-> (req_id, shard_id, uint32 (rows, classes) acc, span trailer)."""
    req_id, shard_id, rows, classes = _U32X4.unpack_from(payload)
    count = rows * classes
    # astype: native byte order + a writable copy (frombuffer views are
    # read-only and the merge accumulates in place)
    acc = np.frombuffer(payload, "<u4", count=count,
                        offset=_U32X4.size).reshape(rows, classes) \
        .astype(np.uint32)
    tail = payload[_U32X4.size + count * 4:]
    spans = [(n, int(a), int(b)) for n, a, b in json.loads(tail or b"[]")]
    return req_id, shard_id, acc, spans


def encode_error(req_id: int, error: str) -> bytes:
    return json.dumps({"req_id": int(req_id), "error": str(error)}).encode()


def decode_error(payload: bytes) -> tuple:
    d = json.loads(payload)
    return int(d.get("req_id", 0)), str(d.get("error", ""))
