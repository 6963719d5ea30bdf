"""Logical-to-mesh sharding rules (path-based, divisibility-checked): the
PyTorch counterpart of the JAX package's ``sharding/rules.py``.

Mesh axes:
  * ``pod``   — pure data parallelism across pods (params replicated),
  * ``data``  — FSDP: batch sharded AND parameter/optimizer-state sharded,
  * ``model`` — tensor parallelism: heads / ffn / experts / vocab.

Every rule is checked against the actual mesh axis sizes: a dimension that
is not divisible by its assigned axis size falls back to replication (e.g.
the 49155-entry granite-3-2b vocab).  Rules match on the *leaf name* (the
last string key of the leaf's path in the nested-dict tree), so stacked
(L, ...) block params get a ``None`` prepended automatically.  The rules
read only ``mesh.shape``; a ``NamedSharding`` turns a spec into DTensor
placements on a real ``ops.Mesh``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.sharding import ops
from repro_torch.sharding.ops import P
from repro_torch.train.tree import flatten_with_paths, path_key, unflatten_like

# leaf-name -> spec for the *unstacked* parameter
_RULES = {
    "embed": ("model", "data"),  # (V, D)
    "head": ("data", "model"),  # (D, V)
    "frontend_proj": (None, "model"),  # (F, D)
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    "w_router": ("data", None),
    "w_gate_e": ("model", "data", None),  # (E, D, F): experts on model
    "w_up_e": ("model", "data", None),
    "w_down_e": ("model", None, "data"),
    "w_in": ("data", "model"),
    "w_out": ("model", "data"),
    "conv_w": ("model", None),
    "a_log": (None,),
    "dt_bias": (None,),
    "d_skip": (None,),
    "norm_gamma": (None,),
    "ln1": (None,),
    "ln2": (None,),
    "final_norm": (None,),
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return ops.placements(self.mesh, self.spec)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def spec_for(path, shape, mesh) -> P:
    name = _leaf_name(path)
    rule = _RULES.get(name)
    if rule is None:
        return P()
    ndim = len(shape)
    base = list(rule)
    # stacked leading dims (blocks: (L, ...); shared sets: (S, ...))
    while len(base) < ndim:
        base.insert(0, None)
    base = base[:ndim]
    out = []
    for dim, axis in zip(shape, base):
        if axis is None:
            out.append(None)
            continue
        size = mesh.shape[axis] if axis in mesh.shape else 1
        out.append(axis if size > 1 and dim % size == 0 else None)
    return P(*out)


def _map_with_path(fn, tree):
    flat = flatten_with_paths(tree)
    return unflatten_like(tree, {path_key(p): fn(p, leaf) for p, leaf in flat})


def params_shardings(params_tree, mesh):
    """Map a params tree (tensors, meta tensors included) -> NamedSharding
    tree."""
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, spec_for(path, leaf.shape, mesh)), params_tree)


def batch_pspec(mesh, batch_size: int) -> P:
    """Batch-axis spec: shard over (pod, data) when divisible."""
    axes = [a for a in ("pod", "data") if a in mesh.shape and mesh.shape[a] > 1]
    total = 1
    used = []
    for a in axes:
        if batch_size % (total * mesh.shape[a]) == 0:
            used.append(a)
            total *= mesh.shape[a]
    return P(tuple(used)) if used else P()


def batch_shardings(mesh, batch_tree):
    """Shard every batch leaf on its leading (batch) dimension."""

    def one(path, leaf):
        spec = batch_pspec(mesh, leaf.shape[0])
        pad = [None] * (len(leaf.shape) - 1)
        return NamedSharding(mesh, P(*(list(spec) + pad)) if spec else P())

    return _map_with_path(one, batch_tree)


def cache_shardings(mesh, cache_tree, *, shard_seq: bool = False):
    """KV/state cache shardings for serving.

    Layout: (L, B, S, K, Dh) for k/v; (L, B, ...) for ssm states.  Batch is
    sharded over (pod, data); kv-heads over model when divisible.  With
    ``shard_seq`` (long-context decode at batch 1), the cache *sequence*
    dim is sharded over data instead — attention over the sharded cache
    becomes a distributed flash-decode (partial softmax + combine,
    ``models.layers._flash_decode_partial``).  The position (``pos``, an
    int here) replicates.  A leaf is read by its global ``shape``: a tensor,
    a ``Block`` (a cache that ``prefill`` made on each rank's rows) or a
    ``transformer.CacheLeaf`` (a shape and dtype, no memory).
    """

    def one(path, leaf):
        name = _leaf_name(path)
        shape = tuple(getattr(leaf, "shape", ()))
        if name in ("k", "v") and len(shape) == 5:
            l, b, s, k, dh = shape
            bspec = batch_pspec(mesh, b)
            bax = bspec[0] if len(bspec) else None
            seq_ax = None
            if shard_seq and "data" in mesh.shape and s % mesh.shape["data"] == 0:
                seq_ax = "data"
                if bax == "data":
                    bax = None
            model_sz = mesh.shape.get("model", 1)
            kax = "model" if model_sz > 1 and k % model_sz == 0 else None
            if kax is None and model_sz > 1 and s % model_sz == 0:
                # kv heads not shardable (GQA k < model): shard the cache
                # sequence over `model` instead — decode attention becomes a
                # distributed flash-decode (partial softmax + psum combine).
                seq_ax = ("model",) if seq_ax is None else (seq_ax, "model")
            return NamedSharding(mesh, P(None, bax, seq_ax, kax, None))
        if name == "pos":
            return NamedSharding(mesh, P())
        # ssm states: (L, B, ...) — shard batch; shard the widest inner dim
        # on model when divisible (conv: channel dim; ssm state: heads dim)
        if len(shape) >= 2:
            bspec = batch_pspec(mesh, shape[1])
            bax = bspec[0] if len(bspec) else None
            rest = [None] * (len(shape) - 2)
            if name == "conv" and len(shape) == 4 and shape[3] % mesh.shape.get("model", 1) == 0:
                rest[-1] = "model"
            if name == "ssm" and len(shape) == 5 and shape[2] % mesh.shape.get("model", 1) == 0:
                rest[0] = "model"
            return NamedSharding(mesh, P(None, bax, *rest))
        return NamedSharding(mesh, P())

    return _map_with_path(one, cache_tree)


def place(tree, shardings):
    """Each tensor of ``tree`` as a ``DTensor`` placed by its
    ``NamedSharding`` (``jax.device_put``'s counterpart): a plain tensor,
    the same global value on every rank, is cut to this rank's block with
    no communication; a ``DTensor`` is redistributed.  Each block is a copy
    that owns its memory, so the global tensors can be freed."""
    flat = dict((path_key(p), s) for p, s in flatten_with_paths(shardings))

    def one(path, leaf):
        s = flat[path_key(path)]
        return ops.from_local(ops.to_local(leaf, s.mesh, s.spec).clone(), s.mesh, s.spec)

    return _map_with_path(one, tree)
