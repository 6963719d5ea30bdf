"""Fixed-point integer cross-replica accumulation — the paper's Sec. III-A
math applied to distributed reductions: the PyTorch counterpart of the JAX
package's ``train/intreeger_allreduce.py``, over a ``torch.distributed``
process group in place of a mesh axis.

The paper sums n bounded per-tree values in uint32 by pre-scaling each with
``2**32/n`` so the total provably fits.  A data-parallel gradient all-reduce
is the same problem: n replicas each contribute a value bounded by ``bound``.
Each replica's contribution is scaled into int32 fixed point by the largest
power of two ``scale`` with

    n * bound * scale <= 2**31 - 1

so the int32 sum cannot overflow.  Integer addition is associative, so the
sum is the same in any reduction order and on any device: bit-reproducible,
unlike a float all-reduce.

The reference computes that power of two as ``exp2(floor(log2(q)))`` in
float32, with ``q`` itself rounded to float32.  XLA's ``exp2`` of an integral
float32 is not exact (``exp2(34.)`` exceeds 2**34) and the float32 ``q`` can
round up past a power of two, so its scale can break the bound and the int32
sum wrap.  Here the exponent is exact: ``q`` in float64 and ``torch.frexp``
(a float32 ``bound`` over a small integer ``n`` cannot sit within float64's
rounding of a power of two), and the float32 power of two is built from its
exponent bits.  The error per element is then at most
``quantization_error_bound`` (copied, numpy float64).
``bound`` comes from an all-reduce of max|x| (one small extra collective)
unless given.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.train.tree import tree_map

_I32_MAX = 2**31 - 1
# the exponents of float32's normal powers of two
_MIN_EXPONENT, _MAX_EXPONENT = -126, 127


def group_size(group=None) -> int:
    """The process group's size: the world's when ``group`` is None, and 1
    when no process group exists."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _all_reduce(t, op, group):
    if dist.is_initialized():
        dist.all_reduce(t, op=op, group=group)
    return t


def _pow2_scale(bound, n_shards: int):
    """The largest power of two ``scale`` with ``n * bound * scale <=
    2**31 - 1``, a float32 tensor (bounds under 1e-30 count as 1e-30, and
    the exponent stays within float32's normal range).  Its bits are built
    from the exponent, so it is exact on every device."""
    q = (_I32_MAX / n_shards) / torch.clamp(bound.double(), min=1e-30)
    exponent = torch.clamp(torch.frexp(q).exponent - 1, _MIN_EXPONENT, _MAX_EXPONENT)
    return ((exponent + 127) << 23).to(torch.int32).view(torch.float32)


def integer_psum(x, group=None, n_shards: int | None = None, bound=None):
    """Deterministic fixed-point all-reduce (sum) of ``x`` over ``group``
    (the world by default; with no process group, a group of one).  Every
    rank calls it with a tensor of the same shape; the float32 result is
    the same bits on every rank and for any rank order."""
    n_shards = n_shards or group_size(group)
    xf = x.float()
    if bound is None:
        bound = _all_reduce(torch.max(torch.abs(xf)), dist.ReduceOp.MAX, group)
    bound = torch.as_tensor(bound, dtype=torch.float32, device=xf.device)
    scale = _pow2_scale(bound, n_shards)
    xi = torch.round(xf * scale).to(torch.int32)
    total = _all_reduce(xi, dist.ReduceOp.SUM, group)
    # int32 -> float exactly: f32 has 24 mantissa bits, totals reach 2^31;
    # split into (total >> 16) * 2^16 + low16, both exactly representable.
    hi = (total >> 16).float() * 65536.0
    lo = (total - ((total >> 16) << 16)).float()
    return (hi + lo) / scale


def integer_pmean(x, group=None, n_shards: int | None = None, bound=None):
    n_shards = n_shards or group_size(group)
    return integer_psum(x, group, n_shards, bound) / n_shards


def integer_psum_tree(tree, group=None, n_shards: int | None = None):
    return tree_map(lambda x: integer_psum(x, group, n_shards), tree)


def quantization_error_bound(n_shards: int, bound: float) -> float:
    """Worst-case |integer_psum - exact_sum| per element.

    The power-of-two floor loses at most 2x vs the ideal scale; each shard
    contributes <= 0.5 rounding units; one final f32 add/divide rounds at
    2^-24 relative.
    """
    scale = (_I32_MAX / n_shards) / max(bound, 1e-30)
    scale_p2 = 2.0 ** np.floor(np.log2(scale))
    return n_shards / (2.0 * scale_p2) + n_shards * bound * 2.0**-23
