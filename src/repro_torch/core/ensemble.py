"""Inference modes, the one numpy finalize, and the torch reference walk.

The paper's three implementations (Sec. IV):
  * ``float``   — float32 threshold compares, float32 probability adds,
  * ``flint``   — int32 key compares, exact uint32 fixed-point adds, float
                  probabilities recovered by one reciprocal multiply,
  * ``integer`` — int32 key compares, uint32 fixed-point adds (InTreeger).

Inference splits into *accumulation* (walk every tree, add its leaf) and
*finalize* (scores and argmax).  For the deterministic modes the accumulator
is a uint32 sum, associative mod 2^32, so any backend, kernel tiling or shard
order gives the same bits.  Finalize stays in numpy, exactly as in the JAX
package: an argmax over uint32 scores held as int32 would misorder every
score >= 2^31 (single-tree forests have them), and the uint32 -> float32
conversion of ``flint`` must round as numpy does.  A margin model (boosted
trees, ``ir.forest_ir``) accumulates the same uint32 sums of its leaves' bit
patterns; its finalize (``integer`` only) reads them as int32, adds the base
and takes the signed argmax.

``_predict`` is the torch walk behind the ``reference`` backend and runs on
any device.  Torch has little uint32 arithmetic, so it accumulates in int64
and masks with ``& 0xFFFFFFFF``; float mode adds the trees one by one in tree
order, as the reference's ``lax.scan`` does, never by a reordered sum.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.fixedpoint import scale_for
from repro_torch.core.flint import float_to_key

MODES = ("float", "flint", "integer")

_U32_MASK = 0xFFFFFFFF


def flint_recip(n_trees: int, scale: int = None) -> np.float32:
    """``1 / (scale * n)`` as float32, computed once in float64."""
    s = scale_for(n_trees) if scale is None else int(scale)
    return np.float32(1.0 / (float(s) * float(n_trees)))


def _finalize_float(acc, n_trees, scale=None):
    """float32 tree sums -> average probabilities.  The reference writes
    ``acc / n`` under ``jit``, which XLA's algebraic simplifier turns into a
    multiply by the float32 reciprocal of the constant ``n``; the port does
    that multiply, so float scores match the reference bit for bit."""
    return acc * (np.float32(1) / np.float32(n_trees))


def _finalize_flint(acc, n_trees, scale=None):
    """uint32 partials -> float32 probabilities via one reciprocal multiply."""
    return acc.astype(np.float32) * flint_recip(n_trees, scale)


@dataclass(frozen=True)
class ModeSpec:
    """Everything that distinguishes one inference mode from another.

      * ``domain_transform`` — float32 feature tensor -> the compare domain
        (identity for ``float``, FlInt int32 keys otherwise),
      * ``acc_dtype``        — the accumulator's numpy dtype,
      * ``leaf_field``       — the leaf table that accumulates,
      * ``finalize``         — numpy ``(acc, n_trees, scale) -> scores``,
      * ``deterministic``    — True when the accumulator is an exact integer
        partial sum (flint/integer).
    """

    name: str
    acc_dtype: Any
    leaf_field: str
    domain_transform: Callable
    finalize: Callable
    deterministic: bool


_MODE_SPECS = {
    "float": ModeSpec(
        name="float",
        acc_dtype=np.float32,
        leaf_field="leaf_probs",
        domain_transform=lambda x: x,
        finalize=_finalize_float,
        deterministic=False,
    ),
    "flint": ModeSpec(
        name="flint",
        acc_dtype=np.uint32,
        leaf_field="leaf_fixed",
        domain_transform=float_to_key,
        finalize=_finalize_flint,
        deterministic=True,
    ),
    "integer": ModeSpec(
        name="integer",
        acc_dtype=np.uint32,
        leaf_field="leaf_fixed",
        domain_transform=float_to_key,
        finalize=lambda acc, n, scale=None: acc,
        deterministic=True,
    ),
}


def mode_spec(mode: str) -> ModeSpec:
    try:
        return _MODE_SPECS[mode]
    except KeyError:
        raise ValueError(f"unknown mode {mode!r}; have {MODES}") from None


def finalize_margins(acc, base):
    """A margin model's finalize: (B, C) uint32 partials -> ``(margins (B, C)
    int32, preds (B,) int32)``.  The partials are the sums of the leaves'
    int32 bit patterns mod 2^32, so their int32 view is the signed leaf sum
    exactly; the model's scale keeps that sum plus the base inside int32
    (``ForestIR._check_margins``), so the int32 add cannot wrap.  ``preds``
    is the first largest margin's class, as numpy's argmax gives it."""
    scores = np.ascontiguousarray(acc, np.uint32).view(np.int32) + np.asarray(base, np.int32)
    return scores, np.argmax(scores, axis=1).astype(np.int32)


def finalize_partials(mode: str, acc, n_trees: int, scale: int = None):
    """The standalone finalize over an averaged forest's (B, C) uint32
    partials, in numpy: the scores are the partials themselves
    (``integer``) or their probabilities (``flint``).

    ``n_trees``/``scale`` are the full ensemble's.  Returns ``(scores,
    preds)``; every backend and plan funnels through this one function, or
    through :func:`finalize_margins` for a margin model.
    """
    spec = mode_spec(mode)
    if not spec.deterministic:
        raise ValueError(f"mode {mode!r} has no integer partials to finalize")
    acc = np.asarray(acc)
    scores = spec.finalize(acc, n_trees, scale)
    return scores, np.argmax(scores, axis=1).astype(np.int32)


def _margin_base(packed, mode: str):
    """A margin model's int32 base margins, or ``None`` for an averaged
    forest; a margin model in any mode but ``integer`` raises ``ValueError``."""
    from repro_torch.ir.forest_ir import margin_ir, refuse_margins

    if mode != "integer":
        refuse_margins(packed, f"mode {mode!r}")
    ir = margin_ir(packed)
    return None if ir is None else ir.base_fixed


def u32_numpy(acc: torch.Tensor) -> np.ndarray:
    """A (B, C) tensor of uint32 partials (as uint32 or its int32 bits) ->
    numpy uint32 on the host."""
    return acc.view(torch.int32).cpu().numpy().view(np.uint32)


def ensemble_device_arrays(packed, mode: str, device) -> dict:
    """The tables one mode walks, as tensors on ``device``: child and
    feature indices int64 (gather indices), thresholds in the mode's compare
    domain, leaves as int64 fixed point or float32 probabilities."""
    spec = mode_spec(mode)
    _margin_base(packed, mode)
    thr = packed.threshold if mode == "float" else packed.threshold_key
    leaf = getattr(packed, spec.leaf_field)
    leaf = leaf.astype(np.int64) if spec.deterministic else leaf.astype(np.float32)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return dict(
        feature=as_t(packed.feature.astype(np.int64)),
        threshold=as_t(thr),
        left=as_t(packed.left.astype(np.int64)),
        right=as_t(packed.right.astype(np.int64)),
        leaf=as_t(leaf),
    )


def _predict(arrays: dict, x: torch.Tensor, depth: int, deterministic: bool):
    """Walk every tree ``depth`` levels (leaves self-loop), then add the
    leaves tree by tree in tree order.

    ``x`` is (B, F) in the thresholds' domain.  Returns (B, C) uint32
    partials (``deterministic``) or float32 sums.
    """
    feature, thr = arrays["feature"], arrays["threshold"]
    t_count, b = feature.shape[0], x.shape[0]
    node = torch.zeros((t_count, b), dtype=torch.int64, device=x.device)
    x_t = x.t()  # (F, B): gather dim 0 picks each row's feature
    for _ in range(depth):
        feat = feature.gather(1, node).clamp(min=0)
        go_left = x_t.gather(0, feat) <= thr.gather(1, node)
        node = torch.where(go_left, arrays["left"].gather(1, node),
                           arrays["right"].gather(1, node))
    leaf = arrays["leaf"]
    acc = torch.zeros((b, leaf.shape[-1]), dtype=leaf.dtype, device=x.device)
    for t in range(t_count):
        acc = acc + leaf[t].index_select(0, node[t])
    if deterministic:
        return (acc & _U32_MASK).to(torch.int32).view(torch.uint32)
    return acc


def predict_partials_mode(packed, X, mode: str, *, device, arrays=None):
    """Accumulate only: (B, C) uint32 partials for a deterministic mode."""
    spec = mode_spec(mode)
    if not spec.deterministic:
        raise ValueError(f"mode {mode!r} does not produce integer partials")
    if arrays is None:
        arrays = ensemble_device_arrays(packed, mode, device)
    x = torch.as_tensor(np.asarray(X, np.float32), device=device)
    return _predict(arrays, spec.domain_transform(x), packed.max_depth, True)


def predict_mode(packed, X, mode: str, *, device, arrays=None):
    """``(scores, preds)`` as numpy for any mode; deterministic modes go
    through :func:`finalize_partials`, a margin model (``integer`` only)
    through :func:`finalize_margins`."""
    spec = mode_spec(mode)
    base = _margin_base(packed, mode)
    if arrays is None:
        arrays = ensemble_device_arrays(packed, mode, device)
    x = torch.as_tensor(np.asarray(X, np.float32), device=device)
    acc = _predict(arrays, spec.domain_transform(x), packed.max_depth,
                   spec.deterministic)
    if base is not None:
        return finalize_margins(u32_numpy(acc), base)
    if spec.deterministic:
        return finalize_partials(mode, u32_numpy(acc), packed.n_trees,
                                 packed.scale)
    scores = spec.finalize(acc.cpu().numpy(), packed.n_trees, packed.scale)
    return scores, np.argmax(scores, axis=1).astype(np.int32)


def predict_float(packed, X, *, device, arrays=None):
    """float32 path: ``(probs (B, C) float32, preds int32)``, the trees
    added in the reference's order and the sums divided by ``n``, as the
    reference's eager ``predict_float`` divides (its jitted routes, and
    ``predict_mode`` here, multiply by the float32 reciprocal)."""
    _margin_base(packed, "float")
    if arrays is None:
        arrays = ensemble_device_arrays(packed, "float", device)
    x = torch.as_tensor(np.asarray(X, np.float32), device=device)
    scores = _predict(arrays, x, packed.max_depth, False).cpu().numpy() / np.float32(packed.n_trees)
    return scores, np.argmax(scores, axis=1).astype(np.int32)


def predict_flint(packed, X, *, device, arrays=None):
    """FlInt-keyed path: integer compares, exact uint32 partials, float32
    probabilities through the finalize's reciprocal multiply."""
    return predict_mode(packed, X, "flint", device=device, arrays=arrays)


def predict_integer(packed, X, *, device, arrays=None):
    """InTreeger path: integer compares and uint32 fixed-point sums."""
    return predict_mode(packed, X, "integer", device=device, arrays=arrays)


def integer_probs(packed, acc) -> np.ndarray:
    """Ensemble-average probabilities (float32 numpy) from the uint32
    scores (a numpy array or a tensor of uint32 or their int32 bits)."""
    from repro_torch.core.fixedpoint import fixed_to_prob
    from repro_torch.ir.forest_ir import refuse_margins

    refuse_margins(packed, "integer_probs")
    if not torch.is_tensor(acc):
        acc = torch.from_numpy(np.ascontiguousarray(acc, np.uint32).view(np.int32))
    return fixed_to_prob(acc, packed.n_trees).cpu().numpy()


def make_partials_fn(packed, mode: str, *, device):
    """``X -> (B, C) uint32 partials`` (deterministic modes only) over the
    mode's tables, put on ``device`` once: the backend's half of a plan."""
    if not mode_spec(mode).deterministic:
        raise ValueError(f"mode {mode!r} does not produce integer partials")
    arrays = ensemble_device_arrays(packed, mode, device)
    return lambda x: predict_partials_mode(packed, x, mode, device=device, arrays=arrays)


def make_predict_fn(packed, mode: str, *, device):
    """``X -> (scores, preds)`` over the mode's tables, put on ``device``
    once."""
    arrays = ensemble_device_arrays(packed, mode, device)
    return lambda x: predict_mode(packed, x, mode, device=device, arrays=arrays)
