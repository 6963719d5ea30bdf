"""packed_leaf: the group-quantized / bit-packed leaf payload layout.

The fifth registered layout.  Node structure stays CSR (same arrays as the
IR: tree-local children, per-tree offsets), but the fixed-point leaf table —
the size-dominant array on deep forests, ``n_leaves * C * 4`` bytes dense —
is stored group-quantized in the style of Jacob et al. (arXiv:1712.05877)
and distributed-llama's Q40 tensor export: the flattened leaf values are cut
into fixed-size groups, each group stores a ``uint32`` base (its minimum)
and a per-group bit width, and every value is encoded as ``value - base`` in
exactly ``width`` bits.

Unlike lossy weight quantization, the encoding here is **exact**: the width
is chosen as the bit length of the largest in-group delta, so decode
recovers every uint32 leaf bit-for-bit and flint/integer conformance is
preserved structurally, not approximately.  On top of the group codec sits
an optional dictionary stage (:func:`pack_leaf_payload`): fixed-point
leaves are ``floor(p * scale)`` and trained leaves are heavily repetitive —
a pure leaf's row is one-hot at ``scale``, impure leaves repeat the same
small-denominator count ratios — so the distinct-value table is typically
tiny and the groups pack ``log2(D)``-bit *indices* instead of ~30-bit raw
values.  The writer keeps whichever encoding is smaller per forest.

Internal-node rows of ``leaf_fixed`` are zero by IR construction, so only
actual leaf rows are encoded; decode scatters them back against the
``feature < 0`` mask.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.fixedpoint import scale_for
from repro_torch.ir.layouts import register_layout

GROUP_SIZE = 64


# ---------------------------------------------------------------------------
# the exact group codec
# ---------------------------------------------------------------------------

def pack_groups(values: np.ndarray, group: int = GROUP_SIZE):
    """Encode a flat uint32 array into (base, bits, payload) — losslessly.

    Per group of ``group`` consecutive values: ``base`` is the group minimum,
    ``bits`` the bit length of the largest delta, and the payload packs each
    delta LSB-first in exactly ``bits`` bits (``np.packbits`` bit order
    within bytes; groups are byte-aligned so they decode independently).
    """
    values = np.ascontiguousarray(values, np.uint32).ravel()
    n = values.size
    n_groups = -(-n // group) if n else 0
    base = np.zeros(n_groups, np.uint32)
    bits = np.zeros(n_groups, np.uint8)
    chunks = []
    for g in range(n_groups):
        v = values[g * group:(g + 1) * group]
        b = v.min()
        delta = (v - b).astype(np.uint64)
        w = int(int(delta.max()).bit_length())
        base[g], bits[g] = b, w
        if w:
            lanes = ((delta[:, None] >> np.arange(w, dtype=np.uint64)) & 1)
            chunks.append(np.packbits(lanes.astype(np.uint8).ravel()))
    payload = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    return base, bits, payload


def unpack_groups(base: np.ndarray, bits: np.ndarray, payload: np.ndarray,
                  n_values: int, group: int = GROUP_SIZE) -> np.ndarray:
    """Exact inverse of :func:`pack_groups` -> (n_values,) uint32."""
    out = np.empty(n_values, np.uint32)
    off = 0
    for g in range(len(base)):
        count = min(group, n_values - g * group)
        w = int(bits[g])
        sl = slice(g * group, g * group + count)
        if w == 0:
            out[sl] = base[g]
            continue
        nbytes = -(-count * w // 8)
        lanes = np.unpackbits(payload[off:off + nbytes])[:count * w]
        lanes = lanes.reshape(count, w).astype(np.uint64)
        delta = (lanes << np.arange(w, dtype=np.uint64)).sum(axis=1)
        out[sl] = base[g] + delta.astype(np.uint32)
        off += nbytes
    return out


def pack_leaf_payload(values: np.ndarray, group: int = GROUP_SIZE):
    """Encode leaf values as (dictionary, base, bits, payload) — lossless.

    Two modes, whichever is smaller:

    * **dictionary** — trained leaves are heavily repetitive (a pure leaf's
      fixed row is one-hot at ``scale``; impure leaves repeat the same
      small-denominator count ratios), so the distinct-value table is tiny
      and the group codec packs *indices* at ~``log2(D)`` bits instead of
      raw ~``log2(scale)``-bit values.
    * **raw** — ``dictionary`` comes back empty and the groups pack the
      values themselves (the fallback when a forest's leaves are near-unique
      and a value table would cost more than it saves).
    """
    values = np.ascontiguousarray(values, np.uint32).ravel()
    uniq, inv = np.unique(values, return_inverse=True)
    d_base, d_bits, d_payload = pack_groups(inv.astype(np.uint32), group)
    r_base, r_bits, r_payload = pack_groups(values, group)
    dict_cost = uniq.nbytes + d_payload.nbytes
    if dict_cost < r_payload.nbytes:
        return uniq, d_base, d_bits, d_payload
    return np.zeros(0, np.uint32), r_base, r_bits, r_payload


def unpack_leaf_payload(dictionary: np.ndarray, base: np.ndarray,
                        bits: np.ndarray, payload: np.ndarray,
                        n_values: int, group: int = GROUP_SIZE) -> np.ndarray:
    """Exact inverse of :func:`pack_leaf_payload` -> (n_values,) uint32."""
    decoded = unpack_groups(base, bits, payload, n_values, group)
    if dictionary.size:
        return np.asarray(dictionary, np.uint32)[decoded]
    return decoded


# ---------------------------------------------------------------------------
# the layout artifact
# ---------------------------------------------------------------------------

@dataclass
class PackedLeafEnsemble:
    """CSR node arrays + group-quantized leaf payload.

    Node arrays mirror the IR exactly (tree-local children, leaves
    self-loop); the leaf table exists only in packed form.  Backends that
    walk node tables call :meth:`decoded_tables` to recover the dense padded
    tables — an explicit, lazy copy, which is what lets the packed artifact
    (and the mmap pages under it, when ITRF-loaded) stay shared and
    read-only.  Exposes the ``PackedEnsemble`` metadata surface so engines
    stay layout-polymorphic.
    """

    feature: np.ndarray  # (total,) int32, -1 for leaf
    threshold: np.ndarray  # (total,) float32 (reporting only)
    threshold_key: np.ndarray  # (total,) int32
    left: np.ndarray  # (total,) int32, tree-local
    right: np.ndarray  # (total,) int32, tree-local
    node_offsets: np.ndarray  # (T+1,) int64
    tree_depths: np.ndarray  # (T,) int32
    pack_dict: np.ndarray  # (D,) uint32 value table; empty = raw mode
    pack_base: np.ndarray  # (n_groups,) uint32
    pack_bits: np.ndarray  # (n_groups,) uint8
    pack_payload: np.ndarray  # (nbytes,) uint8
    n_leaf_values: int  # n_leaves * n_classes
    n_trees: int
    n_classes: int
    n_features: int
    max_depth: int
    group_size: int = GROUP_SIZE
    layout: str = "packed_leaf"
    quant_scale: int = field(default=None, repr=False)
    ir: object = field(default=None, repr=False, compare=False)
    _tables: object = field(default=None, repr=False, compare=False)

    @property
    def scale(self) -> int:
        return self.quant_scale if self.quant_scale is not None \
            else scale_for(self.n_trees)

    @property
    def total_nodes(self) -> int:
        return int(self.node_offsets[-1])

    def decode_leaf_fixed(self) -> np.ndarray:
        """The exact dense (total, C) uint32 leaf table — a fresh copy."""
        values = unpack_leaf_payload(self.pack_dict, self.pack_base,
                                     self.pack_bits, self.pack_payload,
                                     self.n_leaf_values, self.group_size)
        dense = np.zeros((self.total_nodes, self.n_classes), np.uint32)
        dense[self.feature < 0] = values.reshape(-1, self.n_classes)
        return dense

    def decoded_tables(self):
        """Dense padded node tables reconstructed *from the packed payload*
        (not from any IR back-reference), memoized.  This is the serving
        path: a backend built on packed_leaf walks exactly what the codec
        decodes, so conformance gates the codec itself."""
        if self._tables is None:
            from repro_torch.ir.forest_ir import ForestIR

            leaf_fixed = self.decode_leaf_fixed()
            ir = ForestIR(
                feature=self.feature,
                threshold=self.threshold,
                threshold_key=self.threshold_key,
                left=self.left,
                right=self.right,
                leaf_probs=np.zeros(leaf_fixed.shape, np.float64),
                leaf_fixed=leaf_fixed,
                node_offsets=self.node_offsets,
                tree_depths=self.tree_depths,
                n_trees=self.n_trees,
                n_classes=self.n_classes,
                n_features=self.n_features,
                quant_scale=self.quant_scale,
            )
            self._tables = ir.materialize("padded")
        return self._tables

    def nbytes_integer(self) -> int:
        """Bytes of the integer-only packed-leaf deployment artifact."""
        return (
            self.feature.nbytes
            + self.threshold_key.nbytes
            + self.left.nbytes
            + self.right.nbytes
            + self.node_offsets.nbytes
            + self.tree_depths.nbytes
            + self.pack_dict.nbytes
            + self.pack_base.nbytes
            + self.pack_bits.nbytes
            + self.pack_payload.nbytes
        )

    def nbytes_float(self) -> int:
        """Float deployments ship dense float32 leaves (the codec targets
        fixed-point payloads only) — reported for the size table's float
        column, not a servable artifact."""
        return (
            self.feature.nbytes
            + self.threshold.nbytes
            + self.left.nbytes
            + self.right.nbytes
            + self.node_offsets.nbytes
            + self.tree_depths.nbytes
            + self.n_leaf_values * 4
        )


@register_layout("packed_leaf")
def packed_leaf_layout(ir, group: int = GROUP_SIZE) -> PackedLeafEnsemble:
    leaf_values = ir.leaf_fixed[ir.feature < 0].ravel()
    dictionary, base, bits, payload = pack_leaf_payload(leaf_values, group)
    return PackedLeafEnsemble(
        feature=ir.feature,
        threshold=ir.threshold,
        threshold_key=ir.threshold_key,
        left=ir.left,
        right=ir.right,
        node_offsets=ir.node_offsets,
        tree_depths=ir.tree_depths,
        pack_dict=dictionary,
        pack_base=base,
        pack_bits=bits,
        pack_payload=payload,
        n_leaf_values=int(leaf_values.size),
        n_trees=ir.n_trees,
        n_classes=ir.n_classes,
        n_features=ir.n_features,
        max_depth=ir.max_depth,
        group_size=group,
        quant_scale=ir.quant_scale,
        ir=ir,
    )
