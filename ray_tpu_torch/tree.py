"""Parameter trees: nested dicts, lists and tuples of tensors (the
layout of the JAX package's pytrees, kept by the port)."""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple


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


def tree_device(tree: Any) -> Any:
    """The device of the tree's first leaf: where a model whose parameters
    all live on one device runs, whatever its family's keys."""
    return tree_leaves(tree)[0].device


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, structure) in the JAX package's leaf order, which
    `jax.tree.flatten` gives: dict entries by sorted key, lists and
    tuples in order, None an empty subtree with no leaf. `tree_leaves`
    keeps insertion order instead (the order `TrainStep` and `AdamW`
    zip gradients by). The structure is the tree with leaf i replaced by
    the int i, dicts keeping their own key order, so it pickles as plain
    containers and ints."""
    leaves: List[Any] = []

    def walk(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            kids = {k: walk(node[k]) for k in sorted(node)}
            return {k: kids[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        leaves.append(node)
        return len(leaves) - 1

    return leaves, walk(tree)


def tree_unflatten(structure: Any, leaves: Sequence[Any]) -> Any:
    """The tree `tree_flatten` took apart, with `leaves` in its leaves'
    places."""
    def build(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return leaves[node]

    return build(structure)
