"""Pytrees of tensors: nested dicts, tuples and lists with tensor leaves.

The JAX package's parameters and statistics are such trees, walked with
``jax.tree``; these helpers walk them the same way (dict keys in sorted
order, as ``jax.tree.leaves`` does).
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *children) for children in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in tree_leaves(child)]
    if tree is None:
        return []
    return [tree]
