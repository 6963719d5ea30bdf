"""Collective bytes and per-rank memory of one rank's program: the PyTorch
counterpart of the JAX package's ``launch/hlo_analysis.py``.

The reference parses the partitioned HLO text for its collectives and asks
the compiled module for its memory analysis.  Eager PyTorch has no module
to parse: the rank's program is run, and

  * ``CollectiveBytes``, a dispatch mode, sees every ``c10d`` and
    ``_c10d_functional`` collective as it is issued and adds its result
    bytes (the gathered tensor of an all-gather, this rank's share of a
    reduce-scatter, the reduced tensor of an all-reduce) by op kind, under
    the reference's names.  A collective inside a layer loop is issued once
    a layer, so the count is trip-count aware by construction;
  * ``memory_stats`` gives the per-rank bytes of the arguments (exact: the
    local blocks' bytes), of the outputs and of those outputs that share
    storage with an argument, and the temporaries at the peak from
    ``torch.distributed._tools.mem_tracker.MemTracker`` (which works under
    ``FakeTensorMode``, so a 27B-parameter step is tracked without memory).
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# (namespace, op) -> kind, under the reference's names; a ``c10d`` op
# writes its result into its first argument, a ``_c10d_functional`` op
# returns it
_KINDS = {
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allgather_into_tensor_coalesced_"): "all-gather",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allreduce_coalesced_"): "all-reduce",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "reduce_scatter_tensor_coalesced_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "send"): "collective-permute",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
}


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in a (nested) list, tuple or dict."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    return 0


class CollectiveBytes(TorchDispatchMode):
    """Per-rank collective result bytes and counts by op kind, for the
    collectives issued while the mode is active."""

    def __init__(self):
        super().__init__()
        self.bytes = defaultdict(int)
        self.counts = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = _KINDS.get((func.namespace, func.overloadpacket.__name__))
        if kind is not None:
            self.bytes[kind] += tensor_bytes(args[0] if func.namespace == "c10d" else out)
            self.counts[kind] += 1
        return out

    def result(self) -> dict:
        """The reference's record: bytes by kind, ``total`` and ``counts``."""
        out = {k: int(v) for k, v in self.bytes.items()}
        out["total"] = int(sum(self.bytes.values()))
        out["counts"] = {k: int(v) for k, v in self.counts.items()}
        return out


def collective_bytes(fn, *args) -> tuple:
    """(``fn(*args)``, the per-rank collective record of that call)."""
    with CollectiveBytes() as mode:
        out = fn(*args)
    return out, mode.result()


def local_tensors(tree) -> list:
    """This rank's tensors in a (nested) dict, list or tuple: a ``DTensor``
    or ``sharding.ops.Block`` by its local block."""
    from repro_torch.sharding.ops import Block

    out, stack = [], [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, Block):
            out.append(t.local)
        elif torch.is_tensor(t):
            out.append(t.to_local() if hasattr(t, "to_local") else t)
    return out


def _storages(tree) -> dict:
    """{storage: bytes} of this rank's tensors in a tree (a view counts its
    storage once)."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in local_tensors(tree)}


def memory_stats(arguments, outputs, peak_bytes: int) -> dict:
    """The reference's memory record for one rank: ``argument`` bytes (the
    local blocks of every input), ``output`` bytes, ``alias`` bytes (outputs
    that are arguments updated in place), ``temp`` bytes (the peak beyond
    the arguments) and the ``peak`` itself (``MemTracker``'s, the arguments
    included).  Eager PyTorch generates no code: 0."""
    args = _storages(arguments)
    outs = _storages(outputs)
    arg_bytes = sum(args.values())
    return {
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(sum(outs.values())),
        "temp_size_in_bytes": int(max(peak_bytes - arg_bytes, 0)),
        "alias_size_in_bytes": int(sum(v for k, v in outs.items() if k in args)),
        "generated_code_size_in_bytes": 0,
        "peak_bytes": int(peak_bytes),
    }


def tracked_peak(fn, arguments) -> tuple:
    """(``fn()``, the peak bytes on this rank while it ran, the arguments
    counted from the start), by ``MemTracker``."""
    from torch.distributed._tools.mem_tracker import MemTracker

    leaves = local_tensors(arguments)
    tracker = MemTracker()
    tracker.track_external(*leaves)
    with tracker:
        out = fn()
    peak = sum(dev["Total"] for dev in tracker.get_tracker_snapshot("peak").values())
    return out, int(peak)
