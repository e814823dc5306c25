"""Flatten and rebuild nested result structures in ``jax.tree_util``'s
order, without JAX.

A structure is built from dicts (keys in sorted order), NamedTuples
(fields in order), lists and tuples, dataclasses such as ``TreeArena``
(fields in order), and ``None``, which holds no leaf; anything else is a
leaf.  The checkpoint store writes leaves in this order, so a checkpoint
of a structure written by the JAX package restores here and the other way
round; the sharded search packs results by it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

__all__ = ["flatten", "unflatten", "tree_map"]

_LEAF = ("leaf",)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def flatten(tree) -> Tuple[List[Any], tuple]:
    """``(leaves, treedef)``; ``unflatten(treedef, leaves)`` rebuilds."""
    leaves: List[Any] = []

    def go(x):
        if x is None:
            return ("none",)
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", tuple(keys), tuple(go(x[k]) for k in keys))
        if _is_namedtuple(x):
            return ("obj", type(x), tuple(go(v) for v in x))
        if isinstance(x, (list, tuple)):
            return ("seq", type(x), tuple(go(v) for v in x))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = tuple(f.name for f in dataclasses.fields(x))
            return ("data", type(x), names,
                    tuple(go(getattr(x, n)) for n in names))
        leaves.append(x)
        return _LEAF

    return leaves, go(tree)


def unflatten(treedef: tuple, leaves) -> Any:
    it = iter(leaves)

    def go(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: go(c) for k, c in zip(d[1], d[2])}
        if kind == "obj":
            return d[1](*(go(c) for c in d[2]))
        if kind == "seq":
            return d[1](go(c) for c in d[2])
        return d[1](**{n: go(c) for n, c in zip(d[2], d[3])})

    out = go(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the structures in
    ``rest``, which share its structure."""
    leaves, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
