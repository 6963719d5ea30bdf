"""The work a batch of rows needs, counted from the forest's shape alone: the
``rf`` family's counts, and the peaks every family's counts are held to.

The counts hold whatever kernel or layout serves the rows, so a later redesign
cannot make them stale:

- bytes: the rows once (``rows * features * 4``), the model once (``internal
  nodes * 16`` for feature, threshold and two children, and ``leaves * classes
  * 4``), and the partials once (``rows * classes * 4``);
- operations: ``rows * trees * (3 * depth + classes)``: a load, a compare and a
  select a level, and one add a class.

Padding rows and rows served from a cache are no work: callers pass real rows.
Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet): HBM at 3.35 TB/s, and 67
TFLOP/s in float32 outside the tensor cores, the rate nearest to these int32
operations.  They assume the card's full 700 W; the harness prints the card's
power limit beside every run.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12


def model_bytes(cfg: dict) -> int:
    internal = cfg["n_trees"] * (2 ** cfg["depth"] - 1)
    leaves = cfg["n_trees"] * 2 ** cfg["depth"]
    return internal * 16 + leaves * cfg["n_classes"] * 4


def batch_bytes(cfg: dict, rows: int) -> int:
    """Bytes one launch over ``rows`` real rows has to move."""
    return rows * cfg["n_features"] * 4 + model_bytes(cfg) + rows * cfg["n_classes"] * 4


def batch_ops(cfg: dict, rows: int) -> int:
    return rows * cfg["n_trees"] * (3 * cfg["depth"] + cfg["n_classes"])


def least_s(n_bytes: int, ops: int) -> tuple:
    """(least seconds for ``n_bytes`` and ``ops`` at the peaks, "bytes" or
    "operations", whichever sets it)."""
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_ops = ops / NON_TENSOR_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def bound_s(cfg: dict, rows: int) -> tuple:
    """``least_s`` of one launch over ``rows`` rows."""
    return least_s(batch_bytes(cfg, rows), batch_ops(cfg, rows))
