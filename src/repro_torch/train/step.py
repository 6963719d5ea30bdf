"""Train step factories: loss -> grads -> (clip, optional integer DP reduce)
-> AdamW -> new state.  The PyTorch counterpart of the JAX package's
``train/step.py``.

The parameters are float32 leaf tensors; a step gives each ``requires_grad``,
lets autograd accumulate the microbatches' gradients in its ``.grad`` (the
float32 adds of the reference's scan, in microbatch order, with no second
buffer beside the gradients), updates the parameters, ``m`` and ``v`` in
place and drops the gradients.

Under a mesh (``sharding.ops.use_mesh``) ``make_train_step`` is the
reference's FSDP layout done by hand: the parameters and the optimizer
state are ``DTensor``s placed by ``sharding.rules.params_shardings``, the
batch is split over ``pod`` x ``data`` by ``batch_shardings``.  Each rank
hands the model its parameters' blocks (``sharding.ops.Block``) and its
rows: the embedding, head, projector and final norm are gathered once for
the step, and each layer's parameters inside its block, again in the
backward pass under rematerialization, over the batch axes only, into the
rank's ``model`` blocks; the backward of every gather sums the gradient
over the batch axes into this rank's block (a reduce-scatter over ``data``,
an all-reduce where a dimension does not divide), so gradients exist only
as blocks and microbatches add into them.  The model is tensor-parallel
over ``model`` (``models.transformer``): each ``model`` rank computes its
share of every layer from its blocks, and the layers' all-reduces over
``model`` join the shares (the SSM blocks compute their rank's heads and
share of B and C from their pieces of the in-projection and conv, each
gathered from the rank whose block holds it and its gradient sent back).
Each rank updates its own blocks of
the parameters and moments with the global gradient norm
(``optimizer.sharded_global_norm``).
``make_integer_dp_train_step`` is the reference's data-parallel variant over
a mesh's ``data`` axis or a ``torch.distributed`` process group: each rank
takes its slice of the global batch, and the gradients are combined with
the paper's fixed-point integer all-reduce.
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


def _backward_each(cfg: ModelConfig, model, batch: dict, n_micro: int, device):
    """``loss_fn`` of ``model`` (the parameters, or their blocks) on each of
    ``n_micro`` equal slices of the batch's leading axis, each slice's
    backward pass adding into the gradients.  Returns (the summed loss,
    {"ce", "aux"} sums), detached."""
    size = tree_leaves(batch)[0].shape[0] // n_micro
    lsum = torch.zeros((), device=device)
    psum = {"ce": torch.zeros_like(lsum), "aux": torch.zeros_like(lsum)}
    for i in range(n_micro):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss, parts = tfm.loss_fn(cfg, model, mb)
        loss.backward()
        lsum = lsum + loss.detach()
        psum = {k: psum[k] + parts[k].detach() for k in psum}
    return lsum, psum


def accumulate_grads(cfg: ModelConfig, params, batch: dict, n_micro: int = 1):
    """Each parameter's ``.grad`` set to the mean gradient of ``loss_fn``
    over ``n_micro`` equal slices of the batch's leading axis, summed in
    microbatch order.  Returns (mean loss, {"ce", "aux"} means), detached."""
    device = _prepare(params)
    lsum, psum = _backward_each(cfg, params, batch, n_micro, device)
    if n_micro == 1:
        return lsum, psum
    with torch.no_grad():
        for p in tree_leaves(params):
            p.grad.div_(n_micro)
    return lsum / n_micro, {k: v / n_micro for k, v in psum.items()}


def _apply(opt_cfg, params, opt_state, grad_norm=None):
    """AdamW on the gradients in ``.grad``, which are then dropped."""
    grads = tree_map(lambda p: p.grad, params)
    params, opt_state, om = opt.adamw_update(opt_cfg, grads, opt_state, params,
                                             grad_norm=grad_norm)
    for p in tree_leaves(params):
        p.grad = None
    return params, opt_state, om


def _batch_extent(mesh) -> int:
    """The (pod x data) extent the batch splits over: 1 without a mesh."""
    dp = 1
    if mesh is not None:
        for a in ("pod", "data"):
            dp *= mesh.shape.get(a, 1)
    return dp


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[opt.AdamWConfig] = None):
    """Single-step factory with microbatched gradient accumulation.

    ``cfg.microbatches > 1`` splits the global batch on the leading axis and
    accumulates each slice's float32 gradients; activation memory shrinks by
    the microbatch factor while the arithmetic is unchanged.  Each
    microbatch must still fill every batch shard, so the count follows the
    reference's rule with ``dp`` the active mesh's (pod x data) extent, 1
    without a mesh.  Under a mesh whose every axis is 1 the step is the
    one-device step, on the ``DTensor``s' local tensors.
    """
    from repro_torch.sharding.ops import current_mesh, is_trivial

    opt_cfg = opt_cfg or opt.AdamWConfig()

    def train_step(params, opt_state, batch):
        mesh = current_mesh()
        b = tree_leaves(batch)[0].shape[0]
        n_micro = n_microbatches(b, cfg.microbatches, _batch_extent(mesh))
        if not is_trivial(mesh):
            return _sharded_step(cfg, opt_cfg, mesh, n_micro, params, opt_state, batch)
        local = _locals(params)
        device = tree_leaves(local)[0].device
        loss, parts = accumulate_grads(cfg, local, _on_device(batch, device), n_micro)
        _, ostate, om = _apply(opt_cfg, local, _locals(opt_state))
        return params, {**opt_state, "step": ostate["step"]}, {"loss": loss, **parts, **om}

    return train_step


def _locals(tree):
    """Each ``DTensor`` leaf's local tensor (a view, so updates in place
    reach the ``DTensor``); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t, tree)


def _sharded_step(cfg, opt_cfg, mesh, n_micro, params, opt_state, batch):
    from repro_torch.sharding import rules
    from repro_torch.sharding.ops import BATCH_AXES, blocks, pmean, to_local

    batch_axes = tuple(a for a in BATCH_AXES if a in mesh.shape)
    shardings = rules.params_shardings(params, mesh)
    local = _locals(params)
    device = _prepare(local)
    batch = _on_device(batch, device)
    bsh = rules.batch_shardings(mesh, batch)
    rows = {k: to_local(v, mesh, bsh[k].spec) for k, v in batch.items()}
    # this rank's rows through the model split over ``model`` (``loss_fn``
    # with blocks)
    model = tfm.gather_top(blocks(local, shardings))
    loss, parts = _backward_each(cfg, model, rows, n_micro, device)
    del model
    leaves = tree_leaves(local)
    with torch.no_grad():
        # each block's gradient holds its sum over the batch axes' ranks
        # and the microbatches: the mean of the global batch's gradient
        for p in leaves:
            p.grad.div_(n_micro).div_(_batch_extent(mesh))
        norm = opt.sharded_global_norm([p.grad for p in leaves],
                                       [s.spec for s in tree_leaves(shardings)], mesh)
        loss = pmean(loss / n_micro, batch_axes, mesh)
        parts = {k: pmean(v / n_micro, batch_axes, mesh) for k, v in parts.items()}
    _, ostate, om = _apply(opt_cfg, local, _locals(opt_state), grad_norm=norm)
    return params, {**opt_state, "step": ostate["step"]}, {"loss": loss, **parts, **om}


def make_integer_dp_train_step(cfg: ModelConfig, mesh=None,
                               opt_cfg: Optional[opt.AdamWConfig] = None, *, group=None):
    """Variant with the paper-math integer all-reduce over ``mesh``'s
    ``data`` axis, or over ``group`` (the world by default) without a mesh.

    Every rank passes the same global batch and holds the same parameters;
    the rank at ``data`` coordinate r (rank r of the group) computes the
    gradients of rows ``[r * b/n, (r + 1) * b/n)``, as a batch sharded over
    the reference's ``data`` axis is split.  Each gradient is combined with
    ``integer_pmean`` and the loss with a float all-reduce mean; every rank
    then applies the same AdamW update, so the ranks' parameters stay
    bit-identical (pure data parallelism; the parameters replicate).
    """
    from repro_torch.sharding.ops import use_mesh

    opt_cfg = opt_cfg or opt.AdamWConfig()
    if mesh is not None:
        group, n, rank = mesh.group("data"), mesh.shape["data"], mesh.axis_index("data")
    else:
        n = group_size(group)
        rank = dist.get_rank(group) if dist.is_initialized() else 0

    def train_step(params, opt_state, batch):
        device = tree_leaves(params)[0].device
        b = tree_leaves(batch)[0].shape[0]
        if b % n:
            raise ValueError(f"global batch of {b} rows does not split over {n} ranks")
        lo, hi = rank * b // n, (rank + 1) * b // n
        local = _on_device({k: v[lo:hi] for k, v in batch.items()}, device)
        with use_mesh(None):  # this rank's rows through the one-device model
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
