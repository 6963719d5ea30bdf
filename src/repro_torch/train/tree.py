"""Parameter trees (nested dicts, lists and tuples of tensors) in the JAX
package's leaf order.

``jax.tree`` visits a dict's keys sorted and a sequence's items by index, so
a reduction over the leaves (``optimizer.global_norm``) adds in that order
and a checkpoint's manifest lists its leaves in it.  A leaf's path is its
keys and indices joined by ``/`` (``"blocks/attn/wq"``), as the JAX
checkpoint manager names it.
"""
from __future__ import annotations


def flatten_with_paths(tree, prefix: tuple = ()) -> list:
    """``[(path tuple, leaf), ...]`` in the JAX package's order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in flatten_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in flatten_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def path_key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure, keeping it."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(target, leaves_by_key: dict, prefix: tuple = ()):
    """``target``'s structure with each leaf replaced by
    ``leaves_by_key[path_key(path)]``."""
    if isinstance(target, dict):
        return {k: unflatten_like(v, leaves_by_key, prefix + (k,)) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(unflatten_like(v, leaves_by_key, prefix + (i,))
                            for i, v in enumerate(target))
    return leaves_by_key[path_key(prefix)]
