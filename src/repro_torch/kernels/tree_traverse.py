"""The tree-traversal kernels K1, K2 and K3, each beside its plain version.

  * K1 ``tree_traverse_leaf_major``: the bounded walk over ``leaf_major``
    tables (CUDA kernel ``walk_tile<K, Walk::kBounded, ...>``; replaces the
    TPU's ``_kernel_leaf_major`` linear scan).
  * K2 ``tree_traverse_gather``: the per-level gather walk over any node
    order (CUDA kernel ``walk_tile<K, Walk::kGather, ...>``; replaces
    ``_kernel`` with ``impl="gather"``).
  * K3 ``tree_traverse_onehot``: K2's walk with every table read masked
    (CUDA kernel ``walk_tile<K, Walk::kMasked, ...>``; replaces ``_kernel``
    with ``impl="onehot"``).  The TPU kernel reads through compare-iota
    masked sums, so an index outside its table matches no lane and reads 0;
    on well-formed tables K3 and K2 give the same bits.

All three return (B, C) uint32 partials that wrap mod 2^32.  The CUDA
sources are in ``repro_torch/csrc/tree_traverse.cu``.  A wrapper takes its
plain version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  ``LAUNCHES`` counts kernel launches per kernel, so a run
can show which kernel the path took; the gateway launches from executor
threads, so the counts change under a lock.

All three take the nodes as quads only (:func:`pack_node_quads`, one
(T, N, 4) int32 table), so a caller that serves many requests packs once.
They stage each CTA's rows of ``x_keys`` in shared memory
(:func:`tile_bytes`) when a 32-row tile fits in a CTA's 227 KB
(:func:`stages_x`, by the feature count alone), else read ``x_keys`` from
global memory; a CTA shape whose tile does not fit raises.  Each thread
walks :func:`default_walks` trees at once.  ``LAUNCH_SHAPES`` holds the CTA
shape of each kernel's last launch, as launched.

The plain versions keep the reference wrapper's padding semantics: rows pad
to ``block_b``, trees to ``block_t`` with inert trees (feature -1,
self-looping children, zero leaves, no internal nodes).  They walk all trees
at once and accumulate in int64 masked to 32 bits, because torch's uint32
has no add, gather or index_add_.
"""
from __future__ import annotations

import threading

import torch

#: kernel launches per kernel since the last reset (the wrapper adds one
#: where it launches, and nowhere else); ``bitvector`` is K5, whose wrapper
#: is ``kernels/bitvector.py::tree_bitvector``
LAUNCHES = {"leaf_major": 0, "gather": 0, "onehot": 0, "bitvector": 0}
#: the CTA shape of each kernel's last launch: rows and trees per CTA, the
#: walks per thread (K5: the splits and rows per thread), the staging and
#: its shared memory
LAUNCH_SHAPES = {"leaf_major": None, "gather": None, "onehot": None,
                 "bitvector": None}
_LAUNCHES_LOCK = threading.Lock()

_U32_MASK = 0xFFFFFFFF

#: shared memory one CTA may take on the H100 (227 KB), the most rows a CTA
#: takes (the kernels' launch bound), and the walks a thread may carry
SMEM_PER_CTA = 232_448
MAX_TILE_ROWS = 512
#: the most CTAs of grid.y, which carries the tree chunks of every kernel
MAX_TREE_CHUNKS = 65_535
WALKS = (1, 2, 4)
#: walks per thread when the caller names none (fewer when a CTA's tree
#: chunk is shorter)
DEFAULT_WALKS = 4


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
            LAUNCH_SHAPES[name] = None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _pad_inert(x_keys, feature, threshold_key, left, right, leaf_fixed,
               internal_counts, block_b, block_t):
    """Pad rows to ``block_b`` and trees to ``block_t`` with inert trees
    (leaves come back as their int32 bit pattern)."""
    leaf_fixed = leaf_fixed.view(torch.int32)
    b, t, n = x_keys.shape[0], feature.shape[0], feature.shape[1]
    pad_b, pad_t = (-b) % block_b, (-t) % block_t
    if pad_b:
        x_keys = torch.cat([x_keys, x_keys.new_zeros((pad_b, x_keys.shape[1]))])
    if pad_t:
        selfloop = torch.arange(n, dtype=left.dtype, device=left.device).expand(pad_t, n)
        feature = torch.cat([feature, feature.new_full((pad_t, n), -1)])
        threshold_key = torch.cat([threshold_key, threshold_key.new_zeros((pad_t, n))])
        left = torch.cat([left, selfloop])
        right = torch.cat([right, selfloop])
        leaf_fixed = torch.cat([leaf_fixed, leaf_fixed.new_zeros((pad_t, *leaf_fixed.shape[1:]))])
        if internal_counts is not None:
            internal_counts = torch.cat([internal_counts, internal_counts.new_zeros(pad_t)])
    return x_keys, feature, threshold_key, left, right, leaf_fixed, internal_counts


def _step(x_t, feature, threshold_key, left, right, node):
    """One level for every (tree, row): node (T, B) int64 -> next node."""
    feat = feature.gather(1, node).clamp(min=0).long()
    go_left = x_t.gather(0, feat) <= threshold_key.gather(1, node)
    return torch.where(go_left, left.gather(1, node), right.gather(1, node)).long()


def _masked_read(table, node, ok):
    """table[t, node] where ``ok``, else 0 (the index is clamped first)."""
    return torch.where(ok, table.gather(1, torch.where(ok, node, 0)), 0)


def _step_masked(x_t, feature, threshold_key, left, right, node):
    """K3's level: :func:`_step` with every read outside its table read as 0
    (a node outside [0, N), a feature index outside [0, F))."""
    ok = (node >= 0) & (node < feature.shape[1])
    feat = _masked_read(feature, node, ok).clamp(min=0).long()
    f_ok = feat < x_t.shape[0]
    xv = torch.where(f_ok, x_t.gather(0, torch.where(f_ok, feat, 0)), 0)
    go_left = xv <= _masked_read(threshold_key, node, ok)
    return torch.where(go_left, _masked_read(left, node, ok),
                       _masked_read(right, node, ok)).long()


def _sum_leaves(leaf_fixed, node, b, masked: bool = False):
    """acc[r, c] = sum_t leaf_fixed[t, node[t, r], c] mod 2^32, first b rows;
    ``masked`` adds a zero row for a node outside [0, N)."""
    t, n, c = leaf_fixed.shape
    leaf = leaf_fixed.to(torch.int64) & _U32_MASK
    ok = (node >= 0) & (node < n) if masked else None
    idx = torch.where(ok, node, 0) if masked else node
    vals = leaf.gather(1, idx[:, :, None].expand(t, idx.shape[1], c))
    if masked:
        vals = vals * ok[:, :, None]
    acc = vals.sum(0)[:b] & _U32_MASK
    return acc.to(torch.int32).view(torch.uint32)


def leaf_major_plain(x_keys, feature, threshold_key, left, right,
                     internal_counts, leaf_fixed, *, block_b: int,
                     block_t: int) -> torch.Tensor:
    """K1's function in plain PyTorch: each row walks from node 0 while it
    sits inside its tree's internal prefix (at most ``internal_counts[t]``
    steps), then the leaves add up."""
    b = x_keys.shape[0]
    x_keys, feature, threshold_key, left, right, leaf_fixed, internal_counts = \
        _pad_inert(x_keys, feature, threshold_key, left, right, leaf_fixed,
                   internal_counts, block_b, block_t)
    x_t = x_keys.t()
    nint = internal_counts.long()[:, None]
    node = torch.zeros((feature.shape[0], x_keys.shape[0]), dtype=torch.int64,
                       device=x_keys.device)
    for _ in range(int(nint.max()) if nint.numel() else 0):
        inside = node < nint
        if not bool(inside.any()):
            break
        node = torch.where(inside, _step(x_t, feature, threshold_key, left, right, node), node)
    return _sum_leaves(leaf_fixed, node, b)


def _walk_plain(step, masked, x_keys, feature, threshold_key, left, right,
                leaf_fixed, depth, block_b, block_t):
    b = x_keys.shape[0]
    x_keys, feature, threshold_key, left, right, leaf_fixed, _ = _pad_inert(
        x_keys, feature, threshold_key, left, right, leaf_fixed, None,
        block_b, block_t)
    x_t = x_keys.t()
    node = torch.zeros((feature.shape[0], x_keys.shape[0]), dtype=torch.int64,
                       device=x_keys.device)
    for _ in range(depth):
        node = step(x_t, feature, threshold_key, left, right, node)
    return _sum_leaves(leaf_fixed, node, b, masked)


def gather_plain(x_keys, feature, threshold_key, left, right, leaf_fixed, *,
                 depth: int, block_b: int, block_t: int) -> torch.Tensor:
    """K2's function in plain PyTorch: exactly ``depth`` levels of
    ``node = x[row, max(feature, 0)] <= key ? left : right``."""
    return _walk_plain(_step, False, x_keys, feature, threshold_key, left,
                       right, leaf_fixed, depth, block_b, block_t)


def onehot_plain(x_keys, feature, threshold_key, left, right, leaf_fixed, *,
                 depth: int, block_b: int, block_t: int) -> torch.Tensor:
    """K3's function in plain PyTorch: K2's walk where a node outside
    [0, N) reads feature, key and children as 0, a feature index
    ``max(f, 0) >= F`` reads x as 0, and a final node outside [0, N) adds a
    zero leaf row.  Each read is a select over a clamped gather, not the TPU's
    literal compare-iota sum, which would build (B, N) masks."""
    return _walk_plain(_step_masked, True, x_keys, feature, threshold_key,
                       left, right, leaf_fixed, depth, block_b, block_t)


# ---------------------------------------------------------------------------
# node quads and CTA shapes
# ---------------------------------------------------------------------------

def pack_node_quads(feature, threshold_key, left, right) -> torch.Tensor:
    """The (T, N, 4) int32 node table the kernels read, one 16-byte
    ``{feature, threshold_key, left, right}`` per node."""
    return torch.stack((feature, threshold_key, left, right), dim=-1).contiguous()


def tile_stride(n_features: int) -> int:
    """Words per row of the staged tile: F rounded up to odd, so the 32
    rows of a warp reading one feature hit 32 banks."""
    return n_features | 1


def tile_bytes(block_b: int, n_features: int) -> int:
    """Shared memory of a ``block_b``-row tile of ``x_keys``."""
    return block_b * tile_stride(n_features) * 4


def stages_x(n_features: int) -> bool:
    """Whether the kernels stage ``x_keys`` in shared memory: when a 32-row
    tile fits in a CTA (F <= 1,815); above that they read it from global
    memory.  Chosen by shape, never on a failure."""
    return tile_bytes(32, n_features) <= SMEM_PER_CTA


def check_tree_chunks(t: int, block_t: int) -> None:
    """Raise ``ValueError`` where ``t`` trees in chunks of ``block_t`` take
    more CTAs than grid.y holds (:data:`MAX_TREE_CHUNKS`).  The tree count
    itself has no limit: tree offsets are 64-bit in every kernel."""
    chunks = -(-t // block_t)
    if chunks > MAX_TREE_CHUNKS:
        raise ValueError(f"{t} trees in chunks of {block_t} make {chunks} tree chunks, "
                         f"over the {MAX_TREE_CHUNKS} CTAs of grid.y")


def default_walks(block_t: int) -> int:
    """Walks per thread: :data:`DEFAULT_WALKS`, or the largest of
    :data:`WALKS` that a chunk of ``block_t`` trees fills."""
    return max(w for w in WALKS if w <= max(1, min(DEFAULT_WALKS, block_t)))


def check_tile_shape(block_b: int, n_features: int, walks: int,
                     stage_x: bool) -> None:
    """Raise on a CTA shape the kernels do not take; never shrink it."""
    if not (32 <= block_b <= MAX_TILE_ROWS and block_b % 32 == 0):
        raise ValueError(f"the kernels take 32 to {MAX_TILE_ROWS} rows per CTA in "
                         f"multiples of 32, got {block_b}")
    if walks not in WALKS:
        raise ValueError(f"walks must be one of {WALKS}, got {walks}")
    if stage_x and tile_bytes(block_b, n_features) > SMEM_PER_CTA:
        raise ValueError(
            f"a {block_b}-row tile of {n_features} features takes "
            f"{tile_bytes(block_b, n_features)} bytes of shared memory, over "
            f"the {SMEM_PER_CTA} a CTA may take")


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _cuda_args(x_keys, tables: dict):
    """Check what the kernels take and return the int32 views to pass."""
    dev = x_keys.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA tree kernels take CUDA tensors, got {dev}")
    b, f = x_keys.shape
    t, n = tables["quads"].shape[:2]
    shapes = {"x_keys": (b, f), "quads": (t, n, 4), "internal_counts": (t,)}
    out = {}
    for name, a in (("x_keys", x_keys), *tables.items()):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, x_keys on {dev}")
        if name == "leaf_fixed":
            if a.dim() != 3 or a.shape[:2] != (t, n) \
                    or a.dtype not in (torch.uint32, torch.int32):
                raise ValueError("leaf_fixed must be (T, N, C) uint32")
            a = a.view(torch.int32)
        elif a.dtype != torch.int32 or tuple(a.shape) != shapes[name]:
            raise ValueError(
                f"{name} must be int32 of shape {shapes[name]}, got "
                f"{a.dtype} {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        out[name] = a
    if out["quads"].data_ptr() % 16:
        raise ValueError("quads must be 16-byte aligned")
    if not 1 <= n <= 2 ** 28:  # the kernels index a group of 4 trees in 32 bits
        raise ValueError(f"the node tables need 1 to 2**28 nodes per tree, got {n}")
    return out


def _launch(kernel: str, x_keys, tables: dict, ints: tuple, block_b: int,
            block_t: int, walks, stage_x) -> torch.Tensor:
    """Launch ``intreeger_<kernel>``; ``walks`` and ``stage_x`` are taken by
    shape where None (tests pin them)."""
    from repro_torch.kernels._build import load_library

    args = _cuda_args(x_keys, tables)
    b, f = x_keys.shape
    t, n = args["leaf_fixed"].shape[:2]
    c = args["leaf_fixed"].shape[-1]
    if block_t < 1:  # rows per CTA: check_tile_shape below
        raise ValueError(f"bad CTA shape: {block_b} rows x {block_t} trees")
    check_tree_chunks(t, block_t)
    if f < 1:  # every walk reads x[row, max(f, 0)] at least once
        raise ValueError("the CUDA tree kernels need rows with at least one feature")
    walks = default_walks(block_t) if walks is None else walks
    stage_x = stages_x(f) if stage_x is None else bool(stage_x)
    check_tile_shape(block_b, f, walks, stage_x)
    shape = dict(block_b=block_b, block_t=block_t, walks=walks, stage_x=stage_x,
                 smem_bytes=tile_bytes(block_b, f) if stage_x else 0)
    lib = load_library()
    out = torch.zeros((b, c), dtype=torch.int32, device=x_keys.device)
    with torch.cuda.device(x_keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"intreeger_{kernel}")(
            *(a.data_ptr() for a in args.values()), out.data_ptr(),
            b, f, t, n, c, *ints, block_b, block_t, walks, int(stage_x), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES[kernel] += 1
        LAUNCH_SHAPES[kernel] = shape
    return out.view(torch.uint32)


def tree_traverse_leaf_major(x_keys, quads, internal_counts, leaf_fixed, *,
                             block_b: int, block_t: int, _walks=None,
                             _stage_x=None) -> torch.Tensor:
    """K1: (B, C) uint32 partials over ``leaf_major`` tables.

    ``quads`` is the tables' :func:`pack_node_quads`.  ``block_b`` rows and
    ``block_t`` trees per CTA on the card (row and tree block of the padding
    on the CPU).  ``internal_counts`` (T,) int32 is the layout's per-tree
    internal-prefix length.  ``_walks`` and ``_stage_x`` pin the walks per
    thread and the staging for tests; the kernel takes both by shape.
    """
    if x_keys.device.type == "cpu":
        return leaf_major_plain(x_keys, *quads.unbind(-1), internal_counts,
                                leaf_fixed, block_b=block_b, block_t=block_t)
    tables = dict(quads=quads, internal_counts=internal_counts,
                  leaf_fixed=leaf_fixed)
    return _launch("leaf_major", x_keys, tables, (), block_b, block_t, _walks,
                   _stage_x)


def tree_traverse_gather(x_keys, quads, leaf_fixed, *, depth: int,
                         block_b: int, block_t: int, _walks=None,
                         _stage_x=None) -> torch.Tensor:
    """K2: (B, C) uint32 partials, ``depth`` gather levels per tree over any
    node order.  ``quads``, ``_walks`` and ``_stage_x`` as for K1."""
    if x_keys.device.type == "cpu":
        return gather_plain(x_keys, *quads.unbind(-1), leaf_fixed, depth=depth,
                            block_b=block_b, block_t=block_t)
    tables = dict(quads=quads, leaf_fixed=leaf_fixed)
    return _launch("gather", x_keys, tables, (int(depth),), block_b, block_t,
                   _walks, _stage_x)


def tree_traverse_onehot(x_keys, quads, leaf_fixed, *, depth: int,
                         block_b: int, block_t: int, _walks=None,
                         _stage_x=None) -> torch.Tensor:
    """K3: (B, C) uint32 partials, ``depth`` levels per tree as K2 walks
    them, with every read outside its table reading 0: a node outside
    [0, N) reads its quad as zeros, a feature index ``max(f, 0) >= F`` reads
    x as 0, and a walk that ends outside [0, N) adds a zero leaf row.
    ``quads``, ``_walks`` and ``_stage_x`` as for K1."""
    if x_keys.device.type == "cpu":
        return onehot_plain(x_keys, *quads.unbind(-1), leaf_fixed, depth=depth,
                            block_b=block_b, block_t=block_t)
    tables = dict(quads=quads, leaf_fixed=leaf_fixed)
    return _launch("onehot", x_keys, tables, (int(depth),), block_b, block_t,
                   _walks, _stage_x)
