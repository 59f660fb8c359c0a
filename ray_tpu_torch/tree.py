"""Parameter trees: nested dicts, lists and tuples of tensors (the
layout of the JAX package's pytrees, kept by the port)."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """The same structure with `fn` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """Every leaf, depth first, dict entries in insertion order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out
