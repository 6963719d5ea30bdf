"""Boosted trees, as XGBoost and LightGBM grow them for several classes: a
tree for each class in every round, a signed margin at each leaf, added into
its tree's class, and a base margin a class.  The family's yardstick, plain
numpy and PyTorch; it imports nothing of the program outside
``program_model``.

- configuration keys: ``n_rounds``, ``n_classes`` (trees = rounds x classes,
  in the port's ``trees/gbt.py::pack_gbt`` order: class-major, then round),
  ``depth``, ``n_features``, ``learning_rate``, ``threshold_sample_rows``;
- the model, from the family's own stream of the seed: complete trees whose
  splits ``portbench.forest.complete_tree`` draws from ``threshold_sample_rows``
  rows drawn N(0, 1), raw leaf values uniform in [-1, 1), and base margins the
  log-odds ``log(p / (1 - p))`` of a Dirichlet(1) class prior, clipped as
  ``GradientBoostedClassifier.fit`` clips its prior;
- fixed point, as ``pack_gbt`` packs it: ``m_bound = max(max|base|,
  max|leaf| * learning_rate) + 1e-9``, ``scale = float((2**31 - 1) // ((T + 1)
  * ceil(m_bound)))``, each leaf ``floor(learning_rate * leaf * scale)`` in
  float64 as int32, each base ``floor(base * scale)`` as int32;
- the walk: FlInt keys and ``depth`` levels of ``key(x[feature]) <=
  key(threshold)``, as ``portbench.reference`` walks;
- the sum: each tree's leaf added into its class, in int64 over the base, and
  held inside int32; the scores are the (B, C) int32 margins, the prediction
  their first largest class;
- counted work: bytes ``rows * features * 4 + internal nodes * 16 + leaves * 4
  + rows * classes * 4`` (a scalar leaf a tree), operations ``rows * trees *
  (3 * depth + 1)`` (one add a tree), at ``portbench.work``'s peaks.

``rows_dtype=torch.bfloat16`` rounds the rows to bfloat16 first: the control.
"""
from dataclasses import dataclass

import numpy as np
import torch

from portbench import work
from portbench.forest import complete_tree, rng_for
from portbench.reference import keys

# the family's own stream of the seed, apart from portbench.forest's three
STREAM = 3
INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1
# trees walked at a time: bounds the (trees, rows) blocks of one walk
TREES_A_BLOCK = 256


@dataclass
class Boosted:
    """``feature`` (T, N) int32, -1 at leaves; ``threshold`` (T, N) float32;
    ``left``/``right`` (T, N) int32; ``leaf`` (T, N) float64 raw leaf values,
    zero at internal nodes; ``tree_class`` (T,) int32; ``base`` (C,) float64
    base margins; every tree complete, of ``depth`` levels."""

    feature: np.ndarray
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    leaf: np.ndarray
    tree_class: np.ndarray
    base: np.ndarray
    learning_rate: float
    depth: int
    n_features: int

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def n_classes(self) -> int:
        return self.base.shape[0]


def n_trees(cfg: dict) -> int:
    return cfg["n_rounds"] * cfg["n_classes"]


def make_forest(cfg: dict, seed: int) -> Boosted:
    rng = rng_for(seed, STREAM)
    f, c, depth = cfg["n_features"], cfg["n_classes"], cfg["depth"]
    sample = rng.standard_normal((cfg["threshold_sample_rows"], f), dtype=np.float32)
    trees = [complete_tree(rng, sample, depth, f, 1)[:4] for _ in range(n_trees(cfg))]
    feature, threshold, left, right = (np.stack(a) for a in zip(*trees))
    n_int = 2 ** depth - 1
    leaf = np.zeros(feature.shape, np.float64)
    leaf[:, n_int:] = rng.uniform(-1.0, 1.0, (feature.shape[0], feature.shape[1] - n_int))
    prior = np.clip(rng.dirichlet(np.ones(c)), 1e-6, 1 - 1e-6)
    return Boosted(feature=feature, threshold=threshold, left=left, right=right, leaf=leaf,
                   tree_class=np.repeat(np.arange(c, dtype=np.int32), cfg["n_rounds"]),
                   base=np.log(prior / (1 - prior)), learning_rate=float(cfg["learning_rate"]),
                   depth=depth, n_features=f)


def fixed_point(model: Boosted) -> tuple:
    """(leaves (T, N) int32, base (C,) int32) at the overflow-free scale."""
    lr = model.learning_rate
    m_bound = max(float(np.abs(model.base).max()), float(np.abs(model.leaf).max()) * lr) + 1e-9
    scale = float(INT32_MAX // ((model.n_trees + 1) * np.ceil(m_bound)))
    leaf = np.floor(lr * model.leaf * scale).astype(np.int64).astype(np.int32)
    return leaf, np.floor(model.base * scale).astype(np.int32)


class Reference:
    """The model's tables on ``device``, ready to score blocks of rows."""

    def __init__(self, model: Boosted, device, rows_dtype=torch.float32):
        as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
        t, n = model.feature.shape
        leaf, base = fixed_point(model)
        self.device = torch.device(device)
        self.depth = model.depth
        self.rows_dtype = rows_dtype
        self.feature = as_t(np.maximum(model.feature, 0), torch.int64).flatten()
        self.threshold = keys(as_t(model.threshold, torch.float32)).flatten()
        self.left = as_t(model.left, torch.int64).flatten()
        self.right = as_t(model.right, torch.int64).flatten()
        self.leaf = as_t(leaf, torch.int64).flatten()
        self.base = as_t(base, torch.int64)
        self.tree_class = as_t(model.tree_class, torch.int64)
        self.offset = (torch.arange(t, device=self.device) * n)[:, None]

    def partials(self, x: np.ndarray) -> np.ndarray:
        """(B, F) float32 rows -> (B, C) int32 margins."""
        xt = torch.as_tensor(np.ascontiguousarray(x, np.float32), device=self.device)
        xk = keys(xt.to(self.rows_dtype).to(torch.float32)).t().contiguous()  # (F, B)
        b = xk.shape[1]
        cols = torch.arange(b, device=self.device)[None, :]
        # int64 holds the base and every int32 addend exactly
        acc = self.base[:, None].repeat(1, b)  # (C, B)
        for lo in range(0, self.offset.shape[0], TREES_A_BLOCK):
            offset = self.offset[lo:lo + TREES_A_BLOCK]
            node = torch.zeros((offset.shape[0], b), dtype=torch.int64, device=self.device)
            for _ in range(self.depth):
                flat = offset + node
                go_left = xk[self.feature[flat], cols] <= self.threshold[flat]
                node = torch.where(go_left, self.left[flat], self.right[flat])
            acc.index_add_(0, self.tree_class[lo:lo + TREES_A_BLOCK], self.leaf[offset + node])
        if b and (int(acc.min()) < INT32_MIN or int(acc.max()) > INT32_MAX):
            raise ArithmeticError("a margin sum left int32: the scale does not bound it")
        return acc.t().cpu().numpy().astype(np.int32)

    def scores(self, x: np.ndarray, block_rows: int = 65536) -> tuple:
        """(scores (B, C) int32, preds (B,) int32), in blocks of rows."""
        parts = [self.partials(x[i:i + block_rows]) for i in range(0, len(x), block_rows)]
        acc = np.concatenate(parts) if parts else np.zeros((0, self.base.shape[0]), np.int32)
        return acc, np.argmax(acc, axis=1).astype(np.int32)


def batch_bytes(cfg: dict, rows: int) -> int:
    """Bytes one launch over ``rows`` real rows has to move."""
    t, d = n_trees(cfg), cfg["depth"]
    model = t * (2 ** d - 1) * 16 + t * 2 ** d * 4
    return rows * cfg["n_features"] * 4 + model + rows * cfg["n_classes"] * 4


def batch_ops(cfg: dict, rows: int) -> int:
    return rows * n_trees(cfg) * (3 * cfg["depth"] + 1)


def bound_s(cfg: dict, rows: int) -> tuple:
    return work.least_s(batch_bytes(cfg, rows), batch_ops(cfg, rows))


def program_model(model: Boosted):
    """The model as the program's trained booster: a
    ``GradientBoostedClassifier`` with ``trees_[class][round]`` of
    ``TreeArrays`` whose ``leaf_probs`` are the (N, 1) raw leaf values, its
    ``base_``, ``learning_rate`` and ``n_classes_``, and ``n_features_``."""
    from repro_torch.trees import GradientBoostedClassifier, TreeArrays

    def tree(t):
        return TreeArrays(feature=model.feature[t].copy(), threshold=model.threshold[t].copy(),
                          left=model.left[t].copy(), right=model.right[t].copy(),
                          leaf_probs=model.leaf[t][:, None].copy(), depth=model.depth)

    booster = GradientBoostedClassifier(
        n_estimators=int(np.count_nonzero(model.tree_class == 0)), max_depth=model.depth,
        learning_rate=model.learning_rate)
    booster.trees_ = [[tree(t) for t in np.flatnonzero(model.tree_class == c)]
                      for c in range(model.n_classes)]
    booster.base_ = model.base.copy()
    booster.n_classes_ = model.n_classes
    booster.n_features_ = model.n_features
    return booster
