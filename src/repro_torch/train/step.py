"""Train step factories: loss -> grads -> (clip, optional integer DP reduce)
-> AdamW -> new state.  The PyTorch counterpart of the JAX package's
``train/step.py``, on one device per process.

The parameters are float32 leaf tensors; a step gives each ``requires_grad``,
lets autograd accumulate the microbatches' gradients in its ``.grad`` (the
float32 adds of the reference's scan, in microbatch order, with no second
buffer beside the gradients), updates the parameters, ``m`` and ``v`` in
place and drops the gradients.  ``make_integer_dp_train_step`` is the
reference's data-parallel variant over a ``torch.distributed`` process group
in place of a mesh axis: each rank takes its slice of the global batch, and
the gradients are combined with the paper's fixed-point integer all-reduce.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt
from repro_torch.train.intreeger_allreduce import group_size, integer_pmean
from repro_torch.train.tree import tree_leaves, tree_map


def n_microbatches(b: int, microbatches: int, dp: int = 1) -> int:
    """The reference's rule: each microbatch must still fill every one of
    the ``dp`` batch shards, so the count is capped at ``b // dp`` and
    lowered until ``n_micro * dp`` divides ``b``."""
    n_micro = max(1, min(microbatches, b // max(dp, 1)))
    while b % (n_micro * dp) and n_micro > 1:
        n_micro -= 1
    return n_micro


def _on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _prepare(params):
    """Every leaf ready to take a gradient, and TF32 kept off on the card
    (the reference's float32 matmuls and bf16 products summed in float32).
    Returns the parameters' device."""
    device = tree_leaves(params)[0].device
    if device.type == "cuda":
        from repro_torch.models.layers import no_tf32

        no_tf32()
    for p in tree_leaves(params):
        p.grad = None
        p.requires_grad_(True)
    return device


def accumulate_grads(cfg: ModelConfig, params, batch: dict, n_micro: int = 1):
    """Each parameter's ``.grad`` set to the mean gradient of ``loss_fn``
    over ``n_micro`` equal slices of the batch's leading axis, summed in
    microbatch order.  Returns (mean loss, {"ce", "aux"} means), detached."""
    device = _prepare(params)
    size = tree_leaves(batch)[0].shape[0] // n_micro
    lsum = torch.zeros((), device=device)
    psum = {"ce": torch.zeros_like(lsum), "aux": torch.zeros_like(lsum)}
    for i in range(n_micro):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss, parts = tfm.loss_fn(cfg, params, mb)
        loss.backward()
        lsum = lsum + loss.detach()
        psum = {k: psum[k] + parts[k].detach() for k in psum}
    if n_micro == 1:
        return lsum, psum
    with torch.no_grad():
        for p in tree_leaves(params):
            p.grad.div_(n_micro)
    return lsum / n_micro, {k: v / n_micro for k, v in psum.items()}


def _apply(opt_cfg, params, opt_state):
    """AdamW on the gradients in ``.grad``, which are then dropped."""
    grads = tree_map(lambda p: p.grad, params)
    params, opt_state, om = opt.adamw_update(opt_cfg, grads, opt_state, params)
    for p in tree_leaves(params):
        p.grad = None
    return params, opt_state, om


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[opt.AdamWConfig] = None):
    """Single-step factory with microbatched gradient accumulation.

    ``cfg.microbatches > 1`` splits the global batch on the leading axis and
    accumulates each slice's float32 gradients; activation memory shrinks by
    the microbatch factor while the arithmetic is unchanged.  The count
    follows the reference's rule with ``dp`` the size of the default process
    group (1 when none exists).
    """
    opt_cfg = opt_cfg or opt.AdamWConfig()

    def train_step(params, opt_state, batch):
        device = tree_leaves(params)[0].device
        batch = _on_device(batch, device)
        n_micro = n_microbatches(tree_leaves(batch)[0].shape[0], cfg.microbatches,
                                 group_size())
        loss, parts = accumulate_grads(cfg, params, batch, n_micro)
        params, opt_state, om = _apply(opt_cfg, params, opt_state)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step


def make_integer_dp_train_step(cfg: ModelConfig, group=None,
                               opt_cfg: Optional[opt.AdamWConfig] = None):
    """Variant with the paper-math integer all-reduce over ``group`` (the
    world by default).

    Every rank passes the same global batch and holds the same parameters;
    rank r computes the gradients of rows ``[r * b/n, (r + 1) * b/n)``, as a
    batch sharded over the reference's ``data`` axis is split.  Each
    gradient is combined with ``integer_pmean`` and the loss with a float
    all-reduce mean; every rank then applies the same AdamW update, so the
    ranks' parameters stay bit-identical (pure data parallelism).
    """
    opt_cfg = opt_cfg or opt.AdamWConfig()
    n = group_size(group)
    rank = dist.get_rank(group) if dist.is_initialized() else 0

    def train_step(params, opt_state, batch):
        device = tree_leaves(params)[0].device
        b = tree_leaves(batch)[0].shape[0]
        if b % n:
            raise ValueError(f"global batch of {b} rows does not split over {n} ranks")
        lo, hi = rank * b // n, (rank + 1) * b // n
        local = _on_device({k: v[lo:hi] for k, v in batch.items()}, device)
        loss, _ = accumulate_grads(cfg, params, local)
        with torch.no_grad():
            for p in tree_leaves(params):
                p.grad = integer_pmean(p.grad, group, n)
            if dist.is_initialized():
                dist.all_reduce(loss, group=group)
            loss = loss / n
        params, opt_state, om = _apply(opt_cfg, params, opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step
