"""Pytree helpers over nested dicts and lists of tensors (anything
else is a leaf; None an empty node), in jax's flatten order (dict keys
sorted, lists in order), so the port's optimiser sums its leaves and
its checkpoints number them as the reference's `jax.tree` functions
do."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    """The leaves in jax's order (None is an empty node)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure), the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """`leaves` (in `tree_leaves` order) put into the structure of
    `like`."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}  # like's key order
        if isinstance(t, list):
            return [build(v) for v in t]
        if t is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def treedef_str(tree) -> str:
    """The structure as jax prints a PyTreeDef (`meta.json`'s
    "treedef")."""
    def fmt(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(fmt(v) for v in t) + "]"
        return "None" if t is None else "*"
    return f"PyTreeDef({fmt(tree)})"
