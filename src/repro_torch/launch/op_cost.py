"""Flops and a perfect-fusion byte bound of one rank's eager program: the
PyTorch counterpart of the JAX package's ``launch/jaxpr_cost.py``.

The reference walks a closed jaxpr and multiplies each scan body by its
length, because XLA's own cost analysis counts a loop body once.  Eager
PyTorch runs every layer and every microbatch, so ``OpCost``, a dispatch
mode that sees each aten operation as it runs, counts trip counts for
free: nothing is multiplied.

The rules are the reference's, op for op where aten has the counterpart:

  * a contraction (``mm``, ``bmm``, ``addmm``, ``baddbmm``, a convolution)
    costs ``2 * M * N * K`` flops; its operands count as traffic unless
    they derive from an earlier contraction's output (transitively, through
    elementwise ops and views), which a fused flash-style kernel keeps on
    chip; its output is marked derived and not counted;
  * a gather (``index``, ``index_select``, ``gather``, ``embedding``)
    counts twice its output bytes; a scatter (``index_put``, ``scatter``,
    ``index_add``, the scatters that back a slice's gradient, ``copy_`` into
    a slice) twice its update bytes;
  * a reduction counts its inputs' bytes (unless derived) and one flop per
    input element; a transcendental one flop and one transcendental per
    output element; any other op one flop per output element, its traffic
    fused away;
  * layout ops, views, copies and factories cost nothing (the reference
    skips ``reshape``, ``transpose``, ``broadcast_in_dim`` and ``copy``);
  * ``analyze`` adds the function boundary: the bytes of its arguments and
    outputs.

Where aten forces another count than the jaxpr would give, ``flags``
records it: ``softmax`` (one fused aten op: counted as a reduction plus
one transcendental an element, where the jaxpr has a max, a sub, an exp,
a sum and a div) and views passing the derived mark on (the reference's
rule drops the mark at a reshape or transpose; aten's einsum inserts them
around every ``bmm``, so keeping the reference's rule would count a
fused attention's probabilities as traffic).
"""
from __future__ import annotations

from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.launch.comm_analysis import local_tensors

_CONTRACTIONS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "convolution", "_convolution"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take_along_dim"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
             "scatter_add", "scatter_add_", "scatter_reduce", "index_add", "index_add_",
             "slice_scatter", "select_scatter", "as_strided_scatter", "copy_",
             "embedding_dense_backward"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "cumsum",
               "prod", "logsumexp", "var_mean", "var", "std", "norm", "linalg_vector_norm",
               "any", "all", "topk", "sort", "_softmax", "_log_softmax",
               "_softmax_backward_data", "_log_softmax_backward_data"}
_SOFTMAX = {"_softmax", "_log_softmax"}
_TRANSCENDENTAL = {"exp", "log", "log1p", "expm1", "tanh", "sin", "cos", "erf", "erfc",
                   "sigmoid", "rsqrt", "sqrt", "pow", "exp2", "silu", "gelu", "softplus",
                   "log2", "reciprocal"}
# layout ops, views and copies: free, and a view of a derived tensor is derived
_VIEWS = {"view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
          "unsqueeze", "squeeze", "slice", "select", "as_strided", "alias", "detach",
          "unbind", "split", "split_with_sizes", "chunk", "narrow", "movedim", "view_as",
          "_reshape_alias", "clone", "contiguous", "unfold"}
# factories and fills: free
_FREE = {"lift_fresh", "lift_fresh_copy", "zeros", "zeros_like", "ones", "ones_like", "empty",
         "empty_like", "empty_strided", "empty_permuted", "new_zeros", "new_ones", "new_empty",
         "new_empty_strided", "new_full", "full", "full_like", "fill_", "zero_", "arange",
         "scalar_tensor", "_local_scalar_dense", "set_", "resize_"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if torch.is_tensor(t) else 0


def _tensors(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return [tree] if torch.is_tensor(tree) else []


def _contraction_flops(name: str, args, out) -> float:
    if name in ("mm", "addmm"):
        a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "addbmm":
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    # convolution: 2 * output elements * the kernel's elements per output channel
    w = args[1]
    return 2.0 * out.numel() * (w.numel() // max(w.shape[0], 1))


_KIND: dict = {}  # aten overload -> (category, op name)


def _classify(func) -> tuple:
    name = func.overloadpacket.__name__
    if func.namespace != "aten":
        return "free", name  # collectives (comm_analysis counts them) and others
    for cat, names in (("contraction", _CONTRACTIONS), ("view", _VIEWS), ("free", _FREE),
                       ("gather", _GATHERS), ("scatter", _SCATTERS),
                       ("reduction", _REDUCTIONS), ("transcendental", _TRANSCENDENTAL)):
        if name in names:
            return cat, name
    return "elementwise", name


class OpCost(TorchDispatchMode):
    """Flops, perfect-fusion bytes and transcendentals of the aten
    operations that run while the mode is active (this rank's shapes)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_lb = 0.0
        self.transcendentals = 0.0
        self.by_op = Counter()  # flops by aten op
        self.flags = Counter()
        self._derived = WeakIdKeyDictionary()  # tensors a fused kernel keeps on chip

    def _mark(self, out) -> None:
        for t in _tensors(out):
            self._derived[t] = True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = _KIND.get(func)
        if kind is None:
            kind = _KIND[func] = _classify(func)
        cat, name = kind
        if cat == "free":
            return out
        ins = _tensors(args) + _tensors(list((kwargs or {}).values()))
        derived_in = any(t in self._derived for t in ins)
        if cat == "view":
            if derived_in:
                self._mark(out)
                self.flags["views_keep_derived"] += 1
            return out
        outs = _tensors(out)
        if cat == "contraction":
            flops = _contraction_flops(name, args, outs[0])
            operands = ins[:2] if name in ("mm", "bmm", "convolution", "_convolution") \
                else ins[1:3]
            self.bytes_lb += sum(_nbytes(t) for t in operands if t not in self._derived)
            if name in ("addmm", "baddbmm", "addbmm"):
                flops += outs[0].numel()  # the bias add
            self._add(name, flops)
            self._mark(outs)
        elif cat == "gather":
            self.bytes_lb += 2 * sum(_nbytes(t) for t in outs)
        elif cat == "scatter":
            self.bytes_lb += 2 * _nbytes(ins[1] if name == "copy_" else ins[-1])
        elif cat == "reduction":
            self.bytes_lb += sum(_nbytes(t) for t in ins if t not in self._derived)
            self._add(name, float(sum(t.numel() for t in ins)))
            if name in _SOFTMAX:
                self.transcendentals += outs[0].numel()
                self.flags["softmax_one_op"] += 1
        else:  # elementwise, or a transcendental
            n = float(sum(t.numel() for t in outs))
            if cat == "transcendental":
                self.transcendentals += n
            self._add(name, n)
        if derived_in and cat in ("reduction", "elementwise", "transcendental"):
            self._mark(outs)
        return out

    def _add(self, name: str, flops: float) -> None:
        self.flops += flops
        self.by_op[name] += flops

    def result(self) -> dict:
        return {"flops": self.flops, "bytes_lb": self.bytes_lb,
                "transcendentals": self.transcendentals, "flags": dict(self.flags)}


def boundary_bytes(args, out) -> int:
    """The function boundary: this rank's argument and output bytes."""
    return sum(_nbytes(t) for t in local_tensors(list(args))) + \
        sum(_nbytes(t) for t in local_tensors(out))


def analyze(fn, *args) -> dict:
    """Run ``fn(*args)`` under ``OpCost``; return the reference's record
    (``flops``, ``bytes_lb`` with the function boundary, ``transcendentals``,
    ``flags``) of this rank's program, and ``by_op``, the flops by aten
    operation."""
    with OpCost() as cost:
        out = fn(*args)
    rec = cost.result()
    rec["bytes_lb"] += boundary_bytes(args, out)
    rec["by_op"] = {k: v for k, v in sorted(cost.by_op.items(), key=lambda kv: -kv[1])}
    return rec


def scaled(rec: dict, k: float) -> dict:
    """A record's flops, bytes and transcendentals times ``k`` (per rank ->
    global: every rank runs the same program on its own block)."""
    out = dict(rec)
    for key in ("flops", "bytes_lb", "transcendentals"):
        out[key] = rec[key] * k
    if "by_op" in rec:
        out["by_op"] = {op: v * k for op, v in rec["by_op"].items()}
    return out

