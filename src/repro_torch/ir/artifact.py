"""ITRF: the versioned binary forest artifact (mmap-able ForestIR).

The trees/io JSON document is the *interchange* boundary; ITRF is the
*deployment* boundary — the struct-packed binary a production fleet loads.
The file is a fixed little-endian header, a section table, and 64-byte
aligned sections holding the IR's CSR arrays verbatim:

    header  := magic(4s=b"ITRF") version_major(u16) version_minor(u16)
               flags(u32) n_trees(u32) n_classes(u32) n_features(u32)
               total_nodes(u64) quant_scale(u64, 0 = derive from n_trees)
               n_sections(u32), zero-padded to 64 bytes
    section := name(16s, NUL-padded) dtype(8s, numpy str e.g. b"<i4")
               ndim(u32) shape(4 x u64) offset(u64, 64-aligned) nbytes(u64)

Loading with ``mmap=True`` maps the file read-only and returns a
:class:`~repro_torch.ir.forest_ir.ForestIR` whose arrays are numpy views over the
mapping: zero copies, O(1) in forest size, and N co-resident processes
share one page cache.  The views are immutable (numpy refuses writes), and
every layout materializer already copies into fresh arrays, so backends
that need writable or device-resident data pay lazily per layout while the
canonical arrays stay shared.

Versioning mirrors ``trees/io``: a newer *major* version is refused loudly
(never half-parsed), unknown section names are skipped (minor versions may
add sections), and required sections missing raise.  Two optional section
families ride along:

  * ``leaf_pack_*`` — the group-quantized leaf payload (``--pack-leaves``):
    exact codec from :mod:`repro_torch.ir.packed_leaf`; decoded on load (the one
    deliberate copy of that path).
  * ``tune_db`` — a JSON map ``{host key: {route: kwargs}}`` of measured
    autotune winners.  The JAX package keys its entries by
    :func:`host_isa_key` (CPU flags) and its routes as
    ``"backend|layout|mode"``.  This package measures CTA shapes, which
    depend on the card, and its routes carry two more parts (the sorted
    backend kwargs and the device), so it writes its entries under a host
    key of its own, :func:`tune_host_key` (``"torch-cuda:<card name>"`` or
    ``"torch-cpu:<host_isa_key()>"``), which ``host_isa_key()`` can never
    produce.  ``register_artifact`` seeds ``ModelVersion._tuned`` from the
    entries whose host key names a device of this host; every other host's
    entry, the JAX package's included, is carried verbatim and never split.

The bytes of a file are the JAX package's: an artifact written by either
package loads in the other.
"""
from __future__ import annotations

import json
import mmap
import os
import platform
import struct
import tempfile

import numpy as np

__all__ = [
    "ITRF_MAGIC", "ITRF_VERSION",
    "write_itrf", "read_itrf", "read_itrf_bytes", "inspect_itrf",
    "update_tuned", "serialize_tuned", "deserialize_tuned", "host_isa_key",
    "tune_host_key",
]

ITRF_MAGIC = b"ITRF"
ITRF_VERSION = (1, 0)  # (major, minor): major bumps break readers

FLAG_FLOAT = 1  # threshold/leaf_probs sections present
FLAG_PACKED_LEAVES = 2  # leaf_pack_* sections replace leaf_fixed
FLAG_TUNED = 4  # a tune_db section is present

_ALIGN = 64
_HEADER = struct.Struct("<4sHHIIIIQQI")  # 44 bytes, padded to _ALIGN
_SECTION = struct.Struct("<16s8sI4QQQ")  # name dtype ndim shape[4] off nbytes

# sections a reader must find to rebuild the IR (leaf payload checked apart)
_NODE_SECTIONS = ("feature", "threshold_key", "left", "right",
                  "node_offsets", "tree_depths")


def _align(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


# ---------------------------------------------------------------------------
# host identity (the tune_db key)
# ---------------------------------------------------------------------------

def host_isa_key() -> str:
    """A stable name for this host's ISA capabilities, e.g.
    ``"x86_64+avx2+avx512f"``: the JAX package's tune_db host key, and the
    suffix of this package's key for winners measured on the CPU."""
    traits = []
    try:
        with open("/proc/cpuinfo") as fh:
            flags: set = set()
            for line in fh:
                if line.lower().startswith(("flags", "features")):
                    flags.update(line.split(":", 1)[1].split())
        for t in ("avx2", "avx512f"):
            if t in flags:
                traits.append(t)
        if {"neon", "asimd"} & flags:
            traits.append("neon")
    except OSError:
        pass
    return "+".join([platform.machine() or "unknown"] + traits)


#: the prefix of this package's tune_db host keys (no ISA key starts so)
PORT_HOST_PREFIX = "torch-"


def tune_host_key(device):
    """The tune_db host key of winners measured on ``device``:
    ``"torch-cuda:<card name>"`` for a card, ``"torch-cpu:<host_isa_key()>"``
    for the CPU; ``None`` for a CUDA device this host does not have."""
    import torch

    dev = torch.device(device)
    if dev.type == "cpu":
        return f"{PORT_HOST_PREFIX}cpu:{host_isa_key()}"
    if dev.type == "cuda" and torch.cuda.is_available() \
            and (dev.index or 0) < torch.cuda.device_count():
        return f"{PORT_HOST_PREFIX}cuda:{torch.cuda.get_device_name(dev)}"
    return None


def _route_str(key) -> str:
    backend, layout, mode, kwargs, device = key
    return "|".join((backend, layout or "", mode, str(device),
                     json.dumps([list(kv) for kv in kwargs])))


def _route_key(route: str) -> tuple:
    backend, layout, mode, device, kwargs = route.split("|", 4)
    return (backend, layout or None, mode,
            tuple(tuple(kv) for kv in json.loads(kwargs)), device)


def serialize_tuned(tuned: dict) -> dict:
    """``{(backend, layout, mode, kwargs, device): winner}`` (the port's
    tune keys) -> ``{host key: {route string: winner}}``, each entry under
    its device's :func:`tune_host_key`; entries of a device this host does
    not have are dropped."""
    db: dict = {}
    for key, kw in tuned.items():
        host = tune_host_key(key[4])
        if host is not None:
            db.setdefault(host, {})[_route_str(key)] = dict(kw)
    return db


def deserialize_tuned(db: dict) -> dict:
    """The winners of a tune_db that this host can use: the port's entries
    whose host key names the device they were measured on here.  Other
    hosts' entries, and every entry of the JAX package, are skipped
    unread."""
    import torch

    devices = ["cpu"]
    if torch.cuda.is_available():
        devices += [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    here = {tune_host_key(d) for d in devices}
    out = {}
    for host, entries in db.items():
        if host not in here:
            continue
        for route, kw in entries.items():
            key = _route_key(route)
            if tune_host_key(key[4]) == host:
                out[key] = dict(kw)
    return out


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _le(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.astype(a.dtype.newbyteorder("<"), copy=False)


def _write_raw(path, header_fields: tuple, sections: list) -> None:
    """Serialize (header, [(name, ndarray)]) to ``path`` atomically."""
    entries, blobs = [], []
    offset = _align(_HEADER.size) + _align(_SECTION.size * len(sections))
    for name, a in sections:
        a = _le(a)
        nm = name.encode()
        if len(nm) > 16:
            raise ValueError(f"section name {name!r} exceeds 16 bytes")
        if a.ndim > 4:
            raise ValueError(f"section {name!r} has ndim {a.ndim} > 4")
        shape = list(a.shape) + [0] * (4 - a.ndim)
        entries.append(_SECTION.pack(nm, a.dtype.str.encode(), a.ndim,
                                     *shape, offset, a.nbytes))
        blobs.append(a.tobytes())
        offset += _align(a.nbytes)
    head = _HEADER.pack(ITRF_MAGIC, *header_fields, len(sections))
    parts = [head, b"\0" * (_align(_HEADER.size) - len(head))]
    table = b"".join(entries)
    parts += [table, b"\0" * (_align(_SECTION.size * len(sections)) - len(table))]
    for blob in blobs:
        parts += [blob, b"\0" * (_align(len(blob)) - len(blob))]
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".itrf.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(b"".join(parts))
        os.replace(tmp, path)  # atomic: readers see old or new, never torn
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_itrf(path, ir, *, include_float: bool = True,
               pack_leaves: bool = False, tuned: dict = None,
               group: int = None) -> dict:
    """Serialize ``ir`` (a ForestIR) as an ITRF file; returns a summary dict.

    ``include_float=False`` drops the float sections (threshold/leaf_probs)
    — a deterministic-serving artifact at roughly half the bytes; loading
    it yields zero float arrays, so only flint/integer routes may serve it.
    ``pack_leaves=True`` stores the leaf table through the exact group
    codec.  ``tuned`` is a map of the port's tune keys to winners, written
    to the ``tune_db`` section under each device's :func:`tune_host_key`.
    """
    from repro_torch.ir.forest_ir import refuse_margins
    from repro_torch.ir.packed_leaf import GROUP_SIZE, pack_leaf_payload

    refuse_margins(ir, "the ITRF artifact")
    group = int(group or GROUP_SIZE)
    flags = 0
    sections = [
        ("feature", ir.feature.astype(np.int32, copy=False)),
        ("threshold_key", ir.threshold_key.astype(np.int32, copy=False)),
        ("left", ir.left.astype(np.int32, copy=False)),
        ("right", ir.right.astype(np.int32, copy=False)),
        ("node_offsets", ir.node_offsets.astype(np.int64, copy=False)),
        ("tree_depths", ir.tree_depths.astype(np.int32, copy=False)),
    ]
    if pack_leaves:
        flags |= FLAG_PACKED_LEAVES
        values = ir.leaf_fixed[ir.feature < 0].ravel()
        dictionary, base, bits, payload = pack_leaf_payload(values, group)
        sections += [("leaf_pack_dict", dictionary),
                     ("leaf_pack_base", base), ("leaf_pack_bits", bits),
                     ("leaf_pack_data", payload)]
    else:
        sections.append(("leaf_fixed", ir.leaf_fixed.astype(np.uint32,
                                                            copy=False)))
    if include_float:
        flags |= FLAG_FLOAT
        sections += [
            ("threshold", ir.threshold.astype(np.float32, copy=False)),
            ("leaf_probs", ir.leaf_probs.astype(np.float64, copy=False)),
        ]
    meta = {"group_size": group}
    sections.append(("meta", np.frombuffer(json.dumps(meta).encode(),
                                           np.uint8)))
    db = serialize_tuned(tuned or {})
    if db:
        flags |= FLAG_TUNED
        sections.append(("tune_db",
                         np.frombuffer(json.dumps(db).encode(), np.uint8)))
    header = (*ITRF_VERSION, flags, ir.n_trees, ir.n_classes, ir.n_features,
              ir.total_nodes, int(ir.quant_scale or 0))
    _write_raw(path, header, sections)
    return {"path": str(path), "flags": flags,
            "sections": [name for name, _ in sections],
            "file_bytes": os.path.getsize(path)}


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _parse_header(buf) -> dict:
    if len(buf) < _HEADER.size:
        raise ValueError(f"not an ITRF artifact: {len(buf)} bytes")
    (magic, vmaj, vmin, flags, n_trees, n_classes, n_features, total_nodes,
     quant_scale, n_sections) = _HEADER.unpack_from(buf)
    if magic != ITRF_MAGIC:
        raise ValueError(f"not an ITRF artifact: bad magic {magic!r}")
    if vmaj > ITRF_VERSION[0]:
        # mirror trees/io schema gating: refuse loudly, never half-parse
        raise ValueError(
            f"ITRF artifact uses format version {vmaj}.{vmin}, but this "
            f"reader understands <= {ITRF_VERSION[0]}.x; refusing to "
            f"half-parse a newer artifact"
        )
    return dict(version=(vmaj, vmin), flags=flags, n_trees=n_trees,
                n_classes=n_classes, n_features=n_features,
                total_nodes=total_nodes,
                quant_scale=quant_scale or None, n_sections=n_sections)


def _parse_sections(buf, n_sections: int) -> dict:
    """-> {name: (dtype_str, shape, offset, nbytes)} from the section table."""
    out = {}
    off = _align(_HEADER.size)
    for _ in range(n_sections):
        name, dt, ndim, s0, s1, s2, s3, offset, nbytes = \
            _SECTION.unpack_from(buf, off)
        shape = tuple(int(s) for s in (s0, s1, s2, s3)[:ndim])
        out[name.rstrip(b"\0").decode()] = (dt.rstrip(b"\0").decode(),
                                            shape, int(offset), int(nbytes))
        off += _SECTION.size
    return out


def _section_array(buf, entry, *, copy: bool) -> np.ndarray:
    dt_str, shape, offset, nbytes = entry
    dt = np.dtype(dt_str)
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    a = np.frombuffer(buf, dt, count=count, offset=offset).reshape(shape)
    return a.copy() if copy else a


def _parse(buf, *, copy: bool, source=None):
    """Rebuild a ForestIR over ``buf`` (mmap, bytes, or memoryview)."""
    from repro_torch.ir.forest_ir import ForestIR
    from repro_torch.ir.packed_leaf import GROUP_SIZE, unpack_leaf_payload

    head = _parse_header(buf)
    table = _parse_sections(buf, head["n_sections"])
    missing = [n for n in _NODE_SECTIONS if n not in table]
    if missing:
        raise ValueError(f"ITRF artifact missing required sections {missing}")
    sec = lambda name: _section_array(buf, table[name], copy=copy)
    meta = {}
    if "meta" in table:
        meta = json.loads(_section_array(buf, table["meta"],
                                         copy=False).tobytes())
    total, C = head["total_nodes"], head["n_classes"]
    feature = sec("feature")
    if head["flags"] & FLAG_PACKED_LEAVES:
        values = unpack_leaf_payload(
            sec("leaf_pack_dict") if "leaf_pack_dict" in table
            else np.zeros(0, np.uint32),
            sec("leaf_pack_base"),
            sec("leaf_pack_bits"), sec("leaf_pack_data"),
            int((feature < 0).sum()) * C,
            int(meta.get("group_size", GROUP_SIZE)),
        )
        leaf_fixed = np.zeros((total, C), np.uint32)
        leaf_fixed[feature < 0] = values.reshape(-1, C)
    elif "leaf_fixed" in table:
        leaf_fixed = sec("leaf_fixed")
    else:
        raise ValueError("ITRF artifact carries neither leaf_fixed nor "
                         "leaf_pack_* sections")
    if head["flags"] & FLAG_FLOAT:
        threshold, leaf_probs = sec("threshold"), sec("leaf_probs")
    else:  # deterministic-only artifact: float tables are zero
        threshold = np.zeros(total, np.float32)
        leaf_probs = np.zeros((total, C), np.float64)
    ir = ForestIR(
        feature=feature,
        threshold=threshold,
        threshold_key=sec("threshold_key"),
        left=sec("left"),
        right=sec("right"),
        leaf_probs=leaf_probs,
        leaf_fixed=leaf_fixed,
        node_offsets=sec("node_offsets"),
        tree_depths=sec("tree_depths"),
        n_trees=head["n_trees"],
        n_classes=C,
        n_features=head["n_features"],
        quant_scale=head["quant_scale"],
    )
    tuned_db = {}
    if "tune_db" in table:
        tuned_db = json.loads(_section_array(buf, table["tune_db"],
                                             copy=False).tobytes())
    # artifact provenance, read by the registry (tune seeding, load ledger)
    # and the remote plan (HELLO ships the raw artifact bytes)
    ir.itrf_source = str(source) if source is not None else None
    ir.itrf_version = head["version"]
    ir.itrf_flags = head["flags"]
    ir.itrf_tuned = tuned_db
    ir.itrf_bytes = np.frombuffer(buf, np.uint8)
    return ir


def read_itrf(path, *, mmap_arrays: bool = True):
    """Load an ITRF file -> ForestIR.

    ``mmap_arrays=True`` (the default) maps the file read-only and returns
    zero-copy views: O(1) load regardless of forest size, pages shared with
    every other process mapping the same file.  ``mmap_arrays=False`` reads
    the file eagerly and returns private writable copies.
    """
    with open(path, "rb") as fh:
        if mmap_arrays:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
            return _parse(mm, copy=False, source=path)
        return _parse(fh.read(), copy=True, source=path)


def read_itrf_bytes(data):
    """Load an ITRF image already in memory (the worker HELLO fast path):
    arrays are zero-copy read-only views over ``data``."""
    return _parse(data, copy=False)


def inspect_itrf(path) -> dict:
    """Header + section table + tuned hosts, without touching array pages."""
    with open(path, "rb") as fh:
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        head = _parse_header(mm)
        table = _parse_sections(mm, head["n_sections"])
        tuned_hosts = []
        if "tune_db" in table:
            tuned_hosts = sorted(json.loads(
                _section_array(mm, table["tune_db"], copy=False).tobytes()))
        return {
            **{k: v for k, v in head.items() if k != "n_sections"},
            "file_bytes": os.path.getsize(path),
            "sections": {
                name: {"dtype": dt, "shape": list(shape),
                       "offset": off, "nbytes": nb}
                for name, (dt, shape, off, nb) in table.items()
            },
            "tuned_hosts": tuned_hosts,
        }


def update_tuned(path, tuned: dict) -> None:
    """Merge autotune winners into an existing artifact's ``tune_db``
    section (atomic rewrite; all other sections, and every other host's
    entries, are carried verbatim).

    ``tuned`` uses the in-memory form of :func:`serialize_tuned` (normally
    ``ModelVersion._tuned``); each winner lands under its device's
    :func:`tune_host_key`."""
    with open(path, "rb") as fh:
        buf = fh.read()
    head = _parse_header(buf)
    table = _parse_sections(buf, head["n_sections"])
    db = {}
    if "tune_db" in table:
        db = json.loads(_section_array(buf, table["tune_db"],
                                       copy=False).tobytes())
    for host, entries in serialize_tuned(tuned).items():
        db.setdefault(host, {}).update(entries)
    sections = [
        (name, _section_array(buf, entry, copy=False))
        for name, entry in table.items() if name != "tune_db"
    ]
    sections.append(("tune_db",
                     np.frombuffer(json.dumps(db).encode(), np.uint8)))
    vmaj, vmin = head["version"]
    header = (vmaj, vmin, head["flags"] | FLAG_TUNED, head["n_trees"],
              head["n_classes"], head["n_features"], head["total_nodes"],
              int(head["quant_scale"] or 0))
    _write_raw(path, header, sections)
