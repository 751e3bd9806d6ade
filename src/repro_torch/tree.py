"""Nested dicts and lists of tensors in the JAX package's flatten order.

The port's counterpart of the few ``jax.tree`` functions that the training
state needs.  A tree is a dict, a list or tuple, or a leaf; leaves come in
the order of ``jax.tree.leaves``: a dict's keys sorted, a list's items by
index.  Optimizer states and checkpoints follow that order, so a state or a
checkpoint laid out by either package is read leaf for leaf by the other.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_paths(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) of every leaf, in flatten order; a path is the keys and
    indices from the root."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from tree_paths(x, prefix + (i,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every leaf of ``tree`` (and the matching leaves of ``rest``,
    trees of the same structure); the result keeps the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(template, leaves: list):
    """A tree of ``template``'s structure holding ``leaves`` (flatten order)."""
    want = len(tree_leaves(template))
    if len(leaves) != want:
        raise ValueError(f"{len(leaves)} leaves for a template of {want}")
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def tree_get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree
