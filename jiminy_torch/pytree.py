"""Nested containers of tensors (the port's states, observations and
training state): their leaves in `jax.tree.leaves` order, and maps over
one or several trees of the same structure.

A tree is a dict (leaves in sorted-key order, as `jax.tree.leaves` takes
them), a list or tuple, a dataclass instance (its fields in declaration
order), `None` (no leaf), or a leaf (a tensor, a generator, a number).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple)) or (
        dataclasses.is_dataclass(tree) and not isinstance(tree, type)
    )


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs, paths joined by '/'."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out += leaves_with_path(child, f"{prefix}/{name}" if prefix else name)
    return out


def leaves(tree) -> list:
    return [x for _, x in leaves_with_path(tree)]


def map_with_path(fn: Callable, tree, *rest, prefix: str = ""):
    """The tree of `fn(path, leaf, *leaves of rest)`, built like `tree`."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(prefix, tree, *rest)

    def sub(name, child, others):
        return map_with_path(fn, child, *others, prefix=f"{prefix}/{name}" if prefix else name)

    if isinstance(tree, dict):
        return {k: sub(str(k), v, [r[k] for r in rest]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub(str(i), v, [r[i] for r in rest]) for i, v in enumerate(tree))
    return dataclasses.replace(tree, **{
        f.name: sub(f.name, getattr(tree, f.name), [getattr(r, f.name) for r in rest])
        for f in dataclasses.fields(tree) if f.init
    })


def map(fn: Callable, tree, *rest):  # noqa: A001 — the tree counterpart of map
    """The tree of `fn(leaf, *leaves of rest)`, built like `tree`."""
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)
