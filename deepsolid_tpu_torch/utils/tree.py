"""Maps over parameter-shaped trees (dicts and lists with array leaves)."""

from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` (and of trees shaped like it); dicts
    keep their key order, lists and tuples come back as lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out
