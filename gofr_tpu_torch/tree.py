"""Nested containers of tensors, flattened as ``jax.tree_util`` flattens them.

The port's counterpart of the pytree functions the reference's training
step and checkpoint store call: dicts (children in sorted key order, as JAX
sorts them), named tuples (by field), lists and tuples (by index) and
``None`` (a node with no children) are containers; anything else is a
leaf. ``flatten_with_paths`` gives each leaf the path the reference's
checkpoint manifest records (``gofr_tpu/checkpoint._flatten_with_paths``),
so a tree that either package writes restores in the other.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple


def _children(node) -> Optional[List[Tuple[Any, Any]]]:
    """[(key, child)] of a container in flattening order, or None for a
    leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves(tree) -> List[Any]:
    """The leaves of `tree`, in flattening order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    out: List[Any] = []
    for _, child in kids:
        out.extend(leaves(child))
    return out


def unflatten(like, new_leaves) -> Any:
    """A tree of `like`'s structure holding `new_leaves` in flattening
    order."""
    it = iter(new_leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if node is None:
            return None
        built = [(k, build(child)) for k, child in kids]
        if isinstance(node, dict):
            rebuilt = dict(built)
            # keep the caller's key order
            return {k: rebuilt[k] for k in node}
        values = [v for _, v in built]
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*values)
        return type(node)(values)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


_END = object()


def tree_map(fn: Callable, tree, *rest) -> Any:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure)."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def flatten_with_paths(tree) -> Tuple[List[List[Dict[str, Any]]], List[Any]]:
    """(paths, leaves): each leaf's path as the reference's checkpoint
    manifest writes it, a list of steps {"t": "dict", "k": str(key)} (with
    "ki": true for an int key), {"t": "seq", "i": index} or {"t": "attr",
    "k": field}."""
    paths: List[List[Dict[str, Any]]] = []
    out: List[Any] = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            paths.append(path)
            out.append(node)
            return
        named = isinstance(node, tuple) and hasattr(node, "_fields")
        for key, child in kids:
            if isinstance(node, dict):
                step = {"t": "dict", "k": str(key)}
                if isinstance(key, int):
                    step["ki"] = True
            elif named:
                step = {"t": "attr", "k": str(key)}
            else:
                step = {"t": "seq", "i": int(key)}
            walk(child, path + [step])

    walk(tree, [])
    return paths, out
