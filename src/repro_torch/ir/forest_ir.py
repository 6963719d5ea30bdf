"""The canonical, layout-free forest representation.

``ForestIR`` is the single point where quantization happens: FlInt int32
keys of every float32 threshold, and fixed-point leaves of one of two kinds:

  * ``averaged`` (a random forest): uint32 leaf probabilities at scale
    ``floor((2**32-1)/n_trees)``, whose uint32 sums are the scores;
  * ``margin`` (boosted trees, a tree a class a round): each leaf's signed
    margin ``floor(learning_rate * leaf * scale)`` at ``pack_gbt``'s scale
    ``(2**31-1) // ((T+1) * ceil(M))``, stored as its int32 bit pattern in
    its tree's class column of the ``C``-wide leaf row, zeros elsewhere.
    ``tree_class`` and the int32 ``base_fixed`` a class ride along; the
    uint32 sums, read as int32 plus the base, are the margins.

Every layout and walk sums ``leaf_fixed`` rows mod 2^32 whatever the kind, so
both stay exact on every layout.  Every layout is a materialization of this
IR and never re-quantizes.

Storage is CSR-style: per-node arrays for all trees concatenated in tree
order, with ``node_offsets`` (T+1,) delimiting each tree's slice.  Child
indices (``left``/``right``) are tree-local.  In this system the forest is
what weights are elsewhere: :meth:`ForestIR.from_numpy` / :meth:`to_numpy`
carry one quantized forest between packages bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional

import numpy as np

from repro_torch.core.fixedpoint import prob_to_fixed_np, scale_for
from repro_torch.core.flint import float_to_key_np
from repro_torch.obs import profiled

#: the kinds of model an IR holds (module docstring)
AVERAGED, MARGIN = "averaged", "margin"
KINDS = (AVERAGED, MARGIN)
INT32_MAX = 2 ** 31 - 1

#: the canonical CSR arrays under their ITRF section names, with the dtype
#: each is stored in; ``from_numpy`` takes exactly these
ARRAY_DTYPES = {
    "feature": np.int32,
    "threshold": np.float32,
    "threshold_key": np.int32,
    "left": np.int32,
    "right": np.int32,
    "leaf_probs": np.float64,
    "leaf_fixed": np.uint32,
    "node_offsets": np.int64,
    "tree_depths": np.int32,
}


def tree_depth_from_arrays(feature, left, right) -> int:
    """Longest root-to-leaf path of one tree given its flat arrays."""
    depth = 0
    frontier = [(0, 0)]
    while frontier:
        node, d = frontier.pop()
        if feature[node] < 0:
            depth = max(depth, d)
            continue
        frontier.append((int(left[node]), d + 1))
        frontier.append((int(right[node]), d + 1))
    return depth


def is_booster(model) -> bool:
    """A trained booster: ``trees_`` a list a class of lists a round, with
    ``base_`` margins (``trees.GradientBoostedClassifier``'s duck type)."""
    trees = getattr(model, "trees_", None)
    return (getattr(model, "base_", None) is not None and bool(trees)
            and isinstance(trees[0], (list, tuple)))


def margin_ir(model):
    """The margin-kind ForestIR behind ``model`` (an IR or a layout artifact
    that carries its IR), or ``None`` for an averaged forest."""
    ir = model if isinstance(model, ForestIR) else getattr(model, "ir", None)
    return ir if getattr(ir, "kind", AVERAGED) == MARGIN else None


def refuse_margins(model, route: str) -> None:
    """Raise ``ValueError`` naming ``route`` when ``model`` is a margin model."""
    if margin_ir(model) is not None:
        raise ValueError(
            f"{route} does not serve a boosted (margin) model; score it in "
            "'integer' mode on the reference, cuda or bitvector backend "
            "under the single, tree_parallel or row_parallel plan")


@dataclass
class ForestIR:
    """Canonical quantized forest: unpadded CSR node arrays + quantized data.

    Arrays are all ``(total_nodes, ...)`` with trees concatenated in ensemble
    order; ``node_offsets[t] : node_offsets[t+1]`` is tree ``t``'s slice.
    ``left``/``right`` are tree-local node indices; leaves (``feature == -1``)
    self-loop (``left == right == self``).
    """

    feature: np.ndarray  # (total,) int32, -1 for leaf
    threshold: np.ndarray  # (total,) float32
    threshold_key: np.ndarray  # (total,) int32 (FlInt keys)
    left: np.ndarray  # (total,) int32, tree-local
    right: np.ndarray  # (total,) int32, tree-local
    leaf_probs: np.ndarray  # (total, C) float64 (zeros on internal nodes)
    leaf_fixed: np.ndarray  # (total, C) uint32
    node_offsets: np.ndarray  # (T+1,) int64
    tree_depths: np.ndarray  # (T,) int32
    n_trees: int
    n_classes: int
    n_features: int
    # set on sub-forest IRs (see :meth:`subset`): the parent ensemble's
    # fixed-point scale.  None means "a whole ensemble", scale_for(n_trees).
    # A margin IR always sets it: pack_gbt's scale.
    quant_scale: Optional[int] = None
    kind: str = AVERAGED
    # margin IRs only: each tree's class (T,) int32 and the base margins
    # (C,) int32 at the scale
    tree_class: Optional[np.ndarray] = None
    base_fixed: Optional[np.ndarray] = None
    _layouts: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown model kind {self.kind!r}; have {KINDS}")
        if self.kind == MARGIN:
            self._check_margins()

    def _check_margins(self) -> None:
        """A margin IR's tables describe it, and its scale bounds the sum of
        ``T + 1`` terms (every tree's leaf and the base) inside int32."""
        if self.quant_scale is None or self.quant_scale < 1:
            raise ValueError(
                f"margin scale {self.quant_scale!r} cannot bound {self.n_trees + 1} "
                "signed terms inside int32")
        if np.shape(self.tree_class) != (self.n_trees,) \
                or np.shape(self.base_fixed) != (self.n_classes,):
            raise ValueError(f"a margin IR needs tree_class ({self.n_trees},) and "
                             f"base_fixed ({self.n_classes},)")
        term = max(int(np.abs(self.leaf_fixed.view(np.int32).astype(np.int64)).max(initial=0)),
                   int(np.abs(self.base_fixed.astype(np.int64)).max(initial=0)))
        if (self.n_trees + 1) * term > INT32_MAX:
            raise ValueError(
                f"margin terms up to {term} at scale {self.quant_scale}: the sum of "
                f"{self.n_trees + 1} such terms can leave int32")

    # ------------------------------------------------------------ properties
    @property
    def node_counts(self) -> np.ndarray:
        """Per-tree node counts (T,) — the quantity padding erases."""
        return np.diff(self.node_offsets).astype(np.int64)

    @property
    def total_nodes(self) -> int:
        return int(self.node_offsets[-1])

    @property
    def max_nodes(self) -> int:
        return int(self.node_counts.max())

    @property
    def max_depth(self) -> int:
        """Walk length that guarantees leaf arrival in every tree."""
        return int(self.tree_depths.max())

    @property
    def scale(self) -> int:
        """The fixed-point scale ``leaf_fixed`` is quantized at (the parent
        ensemble's for a sub-forest carved by :meth:`subset`; ``pack_gbt``'s
        for a margin IR)."""
        return self.quant_scale if self.quant_scale is not None \
            else scale_for(self.n_trees)

    def trees_per_class(self) -> Optional[list]:
        """A margin IR's tree count a class; ``None`` for an averaged one."""
        if self.kind != MARGIN:
            return None
        return np.bincount(self.tree_class, minlength=self.n_classes).tolist()

    # --------------------------------------------------------- constructors
    @classmethod
    def from_forest(cls, forest) -> "ForestIR":
        """Quantize a trained forest (``trees_``/``n_classes_``/
        ``n_features_`` duck type) into the canonical IR: an averaged IR, or
        a margin IR for a booster (:func:`is_booster`)."""
        if is_booster(forest):
            with profiled("ir.margins"):
                return cls._from_booster(forest)
        trees = forest.trees_
        T = len(trees)
        C = forest.n_classes_
        offsets = np.zeros(T + 1, np.int64)
        np.cumsum([t.n_nodes for t in trees], out=offsets[1:])
        total = int(offsets[-1])
        probs = np.zeros((total, C), np.float64)
        for t, off in zip(trees, offsets[:-1]):
            is_leaf = t.feature < 0
            probs[off:off + t.n_nodes][is_leaf] = t.leaf_probs[is_leaf]
        threshold = np.concatenate([t.threshold for t in trees]).astype(np.float32)
        return cls(
            feature=np.concatenate([t.feature for t in trees]).astype(np.int32),
            threshold=threshold,
            threshold_key=float_to_key_np(threshold),
            left=np.concatenate([t.left for t in trees]).astype(np.int32),
            right=np.concatenate([t.right for t in trees]).astype(np.int32),
            leaf_probs=probs,
            leaf_fixed=prob_to_fixed_np(probs, T),
            node_offsets=offsets,
            tree_depths=np.asarray([t.depth for t in trees], np.int32),
            n_trees=T,
            n_classes=C,
            n_features=forest.n_features_,
        )

    @classmethod
    def _from_booster(cls, booster) -> "ForestIR":
        """A margin IR, quantized by ``trees.gbt.pack_gbt`` itself (scale,
        leaves, base), with the trees class-major as it orders them."""
        from repro_torch.trees.gbt import pack_gbt

        trees = [t for stages in booster.trees_ for t in stages]
        if not (np.isfinite(booster.base_).all()
                and all(np.isfinite(t.leaf_probs).all() for t in trees)):
            raise ValueError("a boosted model with non-finite margins has no scale")
        packed = pack_gbt(booster)
        T, C = len(trees), int(booster.n_classes_)
        counts = [t.n_nodes for t in trees]
        offsets = np.zeros(T + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        total = int(offsets[-1])
        # each node's tree and its index there, and the tree's class column
        tree_of = np.repeat(np.arange(T), counts)
        local = np.arange(total) - offsets[tree_of]
        node, col = np.arange(total), packed.tree_class[tree_of]
        leaf_fixed = np.zeros((total, C), np.uint32)
        leaf_fixed[node, col] = packed.leaf_fixed[tree_of, local].view(np.uint32)
        feature = np.concatenate([t.feature for t in trees]).astype(np.int32)
        leaf = feature < 0
        margins = booster.learning_rate * np.concatenate([t.leaf_probs[:, 0] for t in trees])
        leaf_probs = np.zeros((total, C), np.float64)
        leaf_probs[node[leaf], col[leaf]] = margins[leaf]
        threshold = np.concatenate([t.threshold for t in trees]).astype(np.float32)
        n_features = getattr(booster, "n_features_", 0) or int(feature.max(initial=-1)) + 1
        return cls(
            feature=feature,
            threshold=threshold,
            threshold_key=float_to_key_np(threshold),
            left=np.concatenate([t.left for t in trees]).astype(np.int32),
            right=np.concatenate([t.right for t in trees]).astype(np.int32),
            leaf_probs=leaf_probs,
            leaf_fixed=leaf_fixed,
            node_offsets=offsets,
            tree_depths=np.asarray([t.depth for t in trees], np.int32),
            n_trees=T,
            n_classes=C,
            n_features=int(n_features),
            quant_scale=int(packed.scale),
            kind=MARGIN,
            tree_class=packed.tree_class.astype(np.int32),
            base_fixed=packed.base_fixed.astype(np.int32),
        )

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], *, n_trees: int,
                   n_classes: int, n_features: int,
                   quant_scale: Optional[int] = None) -> "ForestIR":
        """Rebuild an IR from its canonical CSR arrays (``ARRAY_DTYPES``
        names), copied verbatim: nothing is re-quantized, so a forest
        quantized elsewhere serves with the same bits."""
        missing = set(ARRAY_DTYPES) - set(arrays)
        if missing:
            raise ValueError(f"missing ForestIR arrays {sorted(missing)}")
        out = {}
        for name, dtype in ARRAY_DTYPES.items():
            a = np.asarray(arrays[name])
            if a.dtype != dtype:
                raise ValueError(
                    f"array {name!r} has dtype {a.dtype}, expected "
                    f"{np.dtype(dtype)} (from_numpy never converts)")
            out[name] = a.copy()
        total = int(out["node_offsets"][-1])
        if out["node_offsets"].shape != (n_trees + 1,) \
                or out["tree_depths"].shape != (n_trees,):
            raise ValueError(f"node_offsets/tree_depths do not describe "
                             f"{n_trees} trees")
        for name in ("feature", "threshold", "threshold_key", "left", "right"):
            if out[name].shape != (total,):
                raise ValueError(f"array {name!r} must have shape ({total},)")
        for name in ("leaf_probs", "leaf_fixed"):
            if out[name].shape != (total, n_classes):
                raise ValueError(
                    f"array {name!r} must have shape ({total}, {n_classes})")
        return cls(**out, n_trees=int(n_trees), n_classes=int(n_classes),
                   n_features=int(n_features),
                   quant_scale=None if quant_scale is None else int(quant_scale))

    def to_numpy(self) -> dict:
        """The canonical CSR arrays, copied (inverse of :meth:`from_numpy`).
        A margin IR has no such form: its classes and base are not among
        them, so it raises ``ValueError``."""
        refuse_margins(self, "ForestIR.to_numpy")
        return {name: getattr(self, name).copy() for name in ARRAY_DTYPES}

    @classmethod
    def from_packed(cls, packed) -> "ForestIR":
        """Recover the IR from a padded ``PackedEnsemble``.

        Padding nodes are trailing self-looping leaves with zero mass in both
        leaf tables; real leaves carry mass, so each tree's real node count
        is recoverable exactly.  The quantized data is sliced, never
        recomputed.
        """
        T, N = packed.feature.shape
        counts = np.empty(T, np.int64)
        selfloop = np.arange(N, dtype=np.int32)
        for t in range(T):
            pad = (
                (packed.feature[t] < 0)
                & (packed.left[t] == selfloop)
                & (packed.right[t] == selfloop)
                & (packed.leaf_fixed[t].sum(axis=1) == 0)
                & (packed.leaf_probs[t].sum(axis=1) == 0)
            )
            n = N
            while n > 1 and pad[n - 1]:
                n -= 1
            counts[t] = n
        offsets = np.zeros(T + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        take = np.concatenate(
            [t * N + np.arange(counts[t]) for t in range(T)]
        ).astype(np.int64)
        flat = lambda a: a.reshape(T * N, *a.shape[2:])[take]
        feature, left, right = (flat(packed.feature), flat(packed.left),
                                flat(packed.right))
        depths = np.asarray(
            [
                tree_depth_from_arrays(
                    feature[offsets[t]:offsets[t + 1]],
                    left[offsets[t]:offsets[t + 1]],
                    right[offsets[t]:offsets[t + 1]],
                )
                for t in range(T)
            ],
            np.int32,
        )
        return cls(
            feature=feature,
            threshold=flat(packed.threshold),
            threshold_key=flat(packed.threshold_key),
            left=left,
            right=right,
            leaf_probs=flat(packed.leaf_probs).astype(np.float64),
            leaf_fixed=flat(packed.leaf_fixed),
            node_offsets=offsets,
            tree_depths=depths,
            n_trees=packed.n_trees,
            n_classes=packed.n_classes,
            n_features=packed.n_features,
            quant_scale=getattr(packed, "quant_scale", None),
        )

    # ------------------------------------------------------------- sharding
    def subset(self, start: int, stop: int = None) -> "ForestIR":
        """Carve the tree-contiguous sub-forest ``[start, stop)`` by pure CSR
        slicing.  The parent's scale travels along as ``quant_scale``, so the
        sub-forest's partials merge into the parent's bit-exactly.

        Accepts ``subset(slice)`` or ``subset(start, stop)``.
        """
        if isinstance(start, slice):
            if start.step not in (None, 1):
                raise ValueError("tree subsets must be contiguous (step 1)")
            start, stop = start.indices(self.n_trees)[:2]
        if stop is None:
            raise ValueError("subset needs (start, stop) or a slice")
        start, stop = int(start), int(stop)
        if not (0 <= start < stop <= self.n_trees):
            raise ValueError(
                f"tree range [{start}, {stop}) out of bounds for "
                f"{self.n_trees} trees"
            )
        lo, hi = int(self.node_offsets[start]), int(self.node_offsets[stop])
        sl = slice(lo, hi)
        return ForestIR(
            feature=self.feature[sl],
            threshold=self.threshold[sl],
            threshold_key=self.threshold_key[sl],
            left=self.left[sl],
            right=self.right[sl],
            leaf_probs=self.leaf_probs[sl],
            leaf_fixed=self.leaf_fixed[sl],
            node_offsets=self.node_offsets[start:stop + 1] - lo,
            tree_depths=self.tree_depths[start:stop],
            n_trees=stop - start,
            n_classes=self.n_classes,
            n_features=self.n_features,
            quant_scale=self.scale,
            kind=self.kind,
            tree_class=None if self.tree_class is None else self.tree_class[start:stop],
            base_fixed=self.base_fixed,
        )

    # ------------------------------------------------------------- artifacts
    def to_itrf(self, path, **kwargs) -> dict:
        """Serialize as an ITRF binary artifact (see
        :mod:`repro_torch.ir.artifact` for the format and the writer
        options).  A margin IR raises ``ValueError``: ITRF holds no
        classes or base."""
        from repro_torch.ir.artifact import write_itrf

        return write_itrf(path, self, **kwargs)

    @classmethod
    def from_itrf(cls, path, *, mmap: bool = True) -> "ForestIR":
        """Load an ITRF artifact.  ``mmap=True`` returns zero-copy read-only
        views over the file mapping; ``mmap=False`` returns private writable
        copies.  Either way the arrays are the file's bits verbatim, so
        scores are bit-identical to the written IR."""
        from repro_torch.ir.artifact import read_itrf

        return read_itrf(path, mmap_arrays=mmap)

    def nbytes_integer(self) -> int:
        """Bytes of the canonical integer-only CSR arrays."""
        return (self.feature.nbytes + self.threshold_key.nbytes
                + self.left.nbytes + self.right.nbytes
                + self.leaf_fixed.nbytes + self.node_offsets.nbytes
                + self.tree_depths.nbytes)

    def nbytes_float(self) -> int:
        return (self.feature.nbytes + self.threshold.nbytes
                + self.left.nbytes + self.right.nbytes
                + self.leaf_probs.nbytes + self.node_offsets.nbytes
                + self.tree_depths.nbytes)

    # ------------------------------------------------------- materialization
    def materialize(self, layout: str = "padded"):
        """The concrete artifact for one registered layout, memoized per IR."""
        if layout not in self._layouts:
            from repro_torch.ir.layouts import materialize

            self._layouts[layout] = materialize(self, layout)
        return self._layouts[layout]

    def materialized_layouts(self) -> tuple:
        """Names of layouts already built for this IR (no side effects)."""
        return tuple(sorted(self._layouts))

    def nbytes_by_layout(self, mode: str = "integer") -> dict:
        """Deployment-artifact bytes of every registered layout."""
        from repro_torch.ir.layouts import available_layouts

        fn = "nbytes_integer" if mode == "integer" else "nbytes_float"
        return {
            name: getattr(self.materialize(name), fn)()
            for name in available_layouts()
        }


def resolve_artifact(model, layout: str):
    """Coerce ``model`` (ForestIR or a layout artifact) into ``layout``.

    An artifact already in the requested layout passes through untouched;
    anything else resolves through the canonical IR.
    """
    if isinstance(model, ForestIR):
        return model.materialize(layout)
    current = getattr(model, "layout", "padded")
    if current == layout:
        return model
    ir = getattr(model, "ir", None)
    if ir is None:
        if not hasattr(model, "to_ir"):
            raise ValueError(
                f"cannot rematerialize a {type(model).__name__!r} artifact "
                f"(layout {current!r}) as {layout!r}: no IR back-reference"
            )
        ir = model.to_ir()
    return ir.materialize(layout)
