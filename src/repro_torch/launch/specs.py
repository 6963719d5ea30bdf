"""Abstract inputs, parameters, optimizer state and caches for the dry run:
the PyTorch counterpart of the JAX package's ``launch/specs.py``.

Where the reference gives a ``jax.ShapeDtypeStruct`` with a sharding, this
module gives a ``DTensor`` placed by its ``sharding.rules.NamedSharding``
whose local tensor is this rank's block on the ``meta`` device: a shape, a
dtype and a placement, with no memory behind it.  The rank's program runs
on them as it runs on the card (the same aten operations, by each one's
meta kernel), which is what the dry run measures.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.shapes import SHAPES, TREE_SHAPES
from repro_torch.models import transformer as tfm
from repro_torch.sharding import ops, rules
from repro_torch.sharding.ops import P, local_shape
from repro_torch.train.tree import flatten_with_paths, path_key, unflatten_like


def sds(shape, dtype, mesh, spec):
    """A ``DTensor`` of global ``shape`` placed by ``spec``: this rank's
    block, of ``dtype``, on the ``meta`` device."""
    local = torch.empty(local_shape(shape, mesh, spec), dtype=dtype, device="meta")
    return ops.from_local(local, mesh, spec)


def _placed(tree, shardings):
    """Each (meta) tensor of ``tree`` as a block placed by its sharding."""
    flat = {path_key(p): s for p, s in flatten_with_paths(shardings)}
    leaves = {}
    for path, t in flatten_with_paths(tree):
        s = flat[path_key(path)]
        leaves[path_key(path)] = sds(t.shape, t.dtype, s.mesh, s.spec)
    return unflatten_like(tree, leaves)


def batch_specs(cfg: ModelConfig, shape_name: str, mesh, *, with_labels: bool):
    """One global batch of inputs, the batch dimension over (pod, data)."""
    info = SHAPES[shape_name]
    b, s = info["batch"], info["seq"]
    bspec = rules.batch_pspec(mesh, b)
    bax = bspec[0] if len(bspec) else None
    out = {}
    if cfg.family == "audio":
        out["frames"] = sds((b, s, cfg.frontend_dim), torch.bfloat16, mesh, P(bax, None, None))
        if with_labels:
            out["labels"] = sds((b, s), torch.int32, mesh, P(bax, None))
        return out
    if cfg.family == "vlm":
        st = s - cfg.vision_patches
        out["tokens"] = sds((b, st), torch.int32, mesh, P(bax, None))
        out["patches"] = sds((b, cfg.vision_patches, cfg.frontend_dim), torch.bfloat16, mesh,
                              P(bax, None, None))
        if with_labels:
            out["labels"] = sds((b, st), torch.int32, mesh, P(bax, None))
        return out
    out["tokens"] = sds((b, s), torch.int32, mesh, P(bax, None))
    if with_labels:
        out["labels"] = sds((b, s), torch.int32, mesh, P(bax, None))
    return out


def params_specs(cfg: ModelConfig, mesh):
    """The float32 parameters placed by ``rules.params_shardings``."""
    shapes = tfm.param_shapes(cfg)
    return _placed(shapes, rules.params_shardings(shapes, mesh))


def opt_state_specs(cfg: ModelConfig, mesh):
    """AdamW's ``m`` and ``v`` placed as their parameters, ``step``
    replicated (``optimizer.init_opt_state``'s layout)."""
    shapes = tfm.param_shapes(cfg)
    shardings = rules.params_shardings(shapes, mesh)
    return {"m": _placed(shapes, shardings), "v": _placed(shapes, shardings),
            "step": sds((), torch.int32, mesh, P())}


def cache_specs(cfg: ModelConfig, shape_name: str, mesh):
    """(the serving caches placed by ``rules.cache_shardings``, with the
    cache sequence sharded for ``long_500k``, and ``pos`` 0; (batch, seq))."""
    info = SHAPES[shape_name]
    b, s = info["batch"], info["seq"]
    shapes = tfm.init_cache(cfg, b, s, device="meta")
    pos = shapes.pop("pos")
    shardings = rules.cache_shardings(mesh, shapes, shard_seq=shape_name == "long_500k")
    return {**_placed(shapes, shardings), "pos": pos}, (b, s)


def decode_token_specs(cfg: ModelConfig, shape_name: str, mesh):
    b = SHAPES[shape_name]["batch"]
    bspec = rules.batch_pspec(mesh, b)
    bax = bspec[0] if len(bspec) else None
    return sds((b, 1), torch.int32, mesh, P(bax, None))


# --- trees family (the paper's arch) ---------------------------------------

def tree_table_specs(cfg: ModelConfig, mesh):
    """A complete forest's padded tables, replicated on every rank."""
    t = cfg.n_trees
    n = 2 ** (cfg.tree_depth + 1) - 1
    c = cfg.n_classes
    rep = P()
    return {
        "feature": sds((t, n), torch.int32, mesh, rep),
        "threshold_key": sds((t, n), torch.int32, mesh, rep),
        "left": sds((t, n), torch.int32, mesh, rep),
        "right": sds((t, n), torch.int32, mesh, rep),
        "leaf_fixed": sds((t, n, c), torch.uint32, mesh, rep),
    }


def tree_input_specs(cfg: ModelConfig, shape_name: str, mesh):
    """The rows' FlInt keys, split over every mesh axis."""
    rows = TREE_SHAPES[shape_name]["rows"]
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    return sds((rows, cfg.n_tab_features), torch.int32, mesh, P(axes, None))
