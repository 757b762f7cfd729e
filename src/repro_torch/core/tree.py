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


def tree_map_with_path(fn: Callable, tree, *rest, path: tuple = ()):
    """:func:`tree_map` that also passes each leaf's path: the dict keys
    and sequence indices from the root, as ``jax.tree_util``'s
    ``tree_map_with_path`` gives them (``DictKey.key``, ``SequenceKey.idx``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, *children, path=path + (i,))
                          for i, children in enumerate(zip(tree, *rest)))
    if tree is None:
        return None
    return fn(path, tree, *rest)


def tree_structure(tree):
    """The tree with every leaf replaced by 0: equal for trees of one shape."""
    return tree_map(lambda _: 0, tree)


def tree_leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in tree_leaves(child)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure whose leaves are ``leaves``, taken in
    :func:`tree_leaves` order (``jax.tree_util.tree_unflatten``)."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            filled = {k: rec(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(rec(child) for child in node)
        if node is None:
            return None
        return next(it)

    return rec(tree)
