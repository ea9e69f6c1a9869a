"""Walkers for the port's trees: nested dicts, lists and tuples of
tensors (parameters, optimizer state, checkpoints), in the reference's
leaf order (``jax.tree``: dict keys sorted, sequences in order, None an
empty subtree)."""
from __future__ import annotations

from typing import List, Tuple

import torch


def tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over the leaves, ``path`` the tuple of dict
    keys and ``[i]`` sequence entries leading to the leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves_with_names(tree, prefix: Tuple[str, ...] = ()
                           ) -> List[Tuple[str, object]]:
    """(leaf name, leaf) pairs in leaf order: the path of dict keys and
    ``[i]`` sequence entries joined by ``__`` (the reference's
    checkpoint leaf names)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in
                tree_leaves_with_names(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree) for pair in
                tree_leaves_with_names(v, prefix + (f"[{i}]",))]
    return [("__".join(prefix), tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_names(tree)]


def tree_unflatten(template, leaves):
    """``template``'s structure with its leaves replaced, in
    `tree_leaves` order (the reference's ``jax.tree.unflatten``)."""
    it = iter(leaves)

    def rebuild(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)
    return rebuild(template)


def tree_stack(trees):
    """Stack a list of equal-structure trees along a new leading axis
    (None stays None)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_stack(list(xs)) for xs in zip(*trees))
    return torch.stack(trees)


def tree_unstack(tree) -> list:
    """Split the leading (layer) axis: a list of trees.  One ``unbind``
    per leaf, so the backward pass stacks the per-layer gradients once
    (indexing each layer instead would add a zero-filled copy of the
    whole stack per layer)."""
    leaves = [torch.unbind(x, 0) for x in tree_leaves(tree)]
    return [tree_unflatten(tree, [parts[i] for parts in leaves])
            for i in range(len(leaves[0]))]
