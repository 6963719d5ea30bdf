"""AdamW on a parameter tree: the PyTorch counterpart of the JAX package's
``train/optimizer.py``.

Plain functions, no ``torch.optim`` (its bias correction and weight-decay
placement differ from the reference's): float32 moments ``m`` and ``v`` of
each parameter's shape, an int32 ``step`` tensor, the reference's warmup +
cosine schedule and global-norm clipping.  Leaves are visited in the JAX
package's order (``train.tree``), so ``global_norm`` adds the per-leaf sums
in the reference's order.

``adamw_update`` works in place: it scales the gradients by the clip factor
and overwrites the parameters, ``m`` and ``v`` (a full-width model's float32
parameters, gradients and moments fill half a card; copies of them would
not fit beside them).  The arithmetic is the reference's, op for op.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.train.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or a tensor), a float32
    tensor: linear warmup, then cosine decay to ``min_lr_frac``."""
    step = step.float() if torch.is_tensor(step) else torch.tensor(float(step))
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    # the cosine of the float32 angle in float64, rounded once: the
    # correctly rounded float32, which torch's float32 cos misses by an ulp
    # on some steps (1 + cos then doubles the gap near t = 1)
    cos = torch.cos((math.pi * t).double()).float()
    cosine = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + cos)
    return cfg.lr * warm * cosine


def init_opt_state(params):
    """Zero float32 moments beside each parameter (placed as it is, for a
    ``DTensor`` parameter), and ``step`` 0 (int32) on the parameters'
    device."""
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def sharded_global_norm(blocks: list, specs: list, mesh):
    """``global_norm`` of whole gradients held as each rank's ``blocks``
    under ``specs`` on ``mesh``: each leaf's local sum of squares, added
    over the ranks that hold its other blocks.  A leaf replicated along an
    axis is counted by the rank at coordinate 0 of that axis only, so no
    copy is counted twice; the leaves' sums are then added in leaf order,
    as ``global_norm`` adds them."""
    from repro_torch.sharding.ops import entry_axes, psum

    sq = []
    for g, spec in zip(blocks, specs):
        sharded = {a for e in spec for a in entry_axes(e)}
        owner = all(mesh.axis_index(a) == 0 for a in mesh.axis_names
                    if a not in sharded and mesh.shape[a] > 1)
        s = torch.sum(torch.square(g.float()))
        sq.append(s if owner else torch.zeros_like(s))
    total = psum(torch.stack(sq), mesh.axis_names, mesh)
    return torch.sqrt(sum(total.unbind(0)))


def _clip_scale(grads, max_norm: float, norm=None):
    norm = global_norm(grads) if norm is None else norm
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    """(the gradients scaled so their global norm is at most ``max_norm``,
    the norm before scaling)."""
    scale, norm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params, *, grad_norm=None):
    """One AdamW step, in place.  Returns (params, opt_state with its new
    ``step``, {"lr", "grad_norm"}): the same parameter and moment tensors,
    overwritten.  ``grads`` are scaled by the clip factor in place.  Where
    the trees hold one rank's blocks of sharded tensors, ``grad_norm`` is
    the global norm of the whole gradients."""
    scale, gnorm = _clip_scale(grads, cfg.grad_clip, grad_norm)
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
        g = g.float().mul_(scale)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps)).add_(cfg.weight_decay * p)
        p.sub_(upd.mul_(lr))
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
