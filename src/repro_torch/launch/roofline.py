"""Roofline terms of one step: the PyTorch counterpart of the JAX package's
``launch/roofline.py``, with one NVIDIA H100's rates.

Hardware constants (NVIDIA H100 SXM data sheet, dense, at its 700 W
limit): bf16 tensor-core peak 989 TFLOP/s, HBM3 3.35 TB/s, and NVLink 4's
900 GB/s a card both ways together, 450 GB/s each way.

    compute    = flops_global / (chips * PEAK_FLOPS)
    memory     = bytes_global / (chips * HBM_BW)
    collective = collective_bytes_per_dev / LINK_BW

A record gives its flops and bytes as global quantities and its collective
bytes per device: ``launch.dryrun`` writes them, from ``launch.op_cost``
(one rank's flops and byte bound times the ranks) and
``launch.comm_analysis`` (one rank's collective result bytes).
MODEL_FLOPS is the analytic useful work (6·N·D train, 2·N·D forward, with
N_active for MoE); the ratio MODEL_FLOPS / flops_global flags
recomputation and redundant work.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.shapes import SHAPES, TREE_SHAPES

PEAK_FLOPS = 989e12  # bf16 / card
HBM_BW = 3.35e12  # bytes/s / card
LINK_BW = 450e9  # bytes/s / card, one way over NVLink 4


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """Analytic useful FLOPs per step (global)."""
    if cfg.family == "trees":
        rows = TREE_SHAPES[shape_name]["rows"]
        # per (row, tree, level): 1 int compare + 3 gathers + final C adds
        return float(rows * cfg.n_trees * (cfg.tree_depth * 4 + cfg.n_classes))
    info = SHAPES[shape_name]
    n = cfg.active_param_count()
    if info["mode"] == "train":
        tokens = info["batch"] * info["seq"]
        return 6.0 * n * tokens
    if info["mode"] == "prefill":
        tokens = info["batch"] * info["seq"]
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * info["batch"]


def terms(record: dict) -> dict:
    """record: ``chips``, ``jaxpr_cost`` {``flops``, ``bytes_lb``} (global),
    ``collectives`` {``total``} (per device), ``model_flops``."""
    chips = record["chips"]
    flops_dev = record["jaxpr_cost"]["flops"] / chips
    bytes_dev = record["jaxpr_cost"]["bytes_lb"] / chips
    coll_dev = record["collectives"]["total"]
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_dev / LINK_BW
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    mf = record.get("model_flops", 0.0)
    hlo_global = flops_dev * chips
    bound = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_ratio": (mf / hlo_global) if hlo_global else 0.0,
        "step_time_lb_s": bound,
        "mfu_bound": (mf / chips / PEAK_FLOPS) / bound if bound > 0 else 0.0,
    }
