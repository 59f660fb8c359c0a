"""Parameter trees: nested containers of tensors with `jax.tree`'s node
rules, so a tree means the same in the port as in the JAX package.

Nodes, each rebuilt as its own type:
- a plain `dict` and a `defaultdict` (which keeps its `default_factory`);
  `jax.tree` orders their children by sorted key;
- an `OrderedDict`, in insertion order;
- a `list` and a `tuple`, in order;
- a namedtuple, its fields in order, rebuilt from positional children;
- None, an empty subtree with no leaf.
Anything else is a leaf, other tuple, list and dict subclasses too, as in
`jax.tree`.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Any, Callable, Iterable, List, Sequence, Tuple

_DICTS = (dict, OrderedDict, defaultdict)


def is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def is_node(x: Any) -> bool:
    """Whether x is a container node (None, the empty subtree, is not)."""
    return type(x) in _DICTS or type(x) in (list, tuple) or is_namedtuple(x)


def rebuild(node: Any, children: Iterable) -> Any:
    """A container of `node`'s type holding `children`: (key, value) pairs
    for a dict node, in the order to keep; values for a list or tuple."""
    if isinstance(node, defaultdict):
        return defaultdict(node.default_factory, children)
    if isinstance(node, dict):
        return type(node)(children)
    if is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def jax_keys(node: dict) -> List[Any]:
    """A dict node's keys in `jax.tree`'s order: sorted, but an
    OrderedDict's in insertion order."""
    return list(node) if type(node) is OrderedDict else sorted(node)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """The same structure with `fn` applied to every leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict) and is_node(tree):
        return rebuild(tree, ((k, tree_map(fn, v)) for k, v in tree.items()))
    if is_node(tree):
        return rebuild(tree, [tree_map(fn, v) for v in tree])
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
    `jax.tree.flatten` gives (see the module docstring). `tree_leaves`
    keeps insertion order for plain dicts instead (the order `TrainStep`
    and `AdamW` zip gradients by). The structure is the tree with leaf i
    replaced by the int i, each container of its own type and dicts in
    their own key order, so it pickles as those containers and ints."""
    leaves: List[Any] = []

    def walk(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, dict) and is_node(node):
            kids = {k: walk(node[k]) for k in jax_keys(node)}
            return rebuild(node, ((k, kids[k]) for k in node))
        if is_node(node):
            return rebuild(node, [walk(v) for v in node])
        leaves.append(node)
        return len(leaves) - 1

    return leaves, walk(tree)


def tree_unflatten(structure: Any, leaves: Sequence[Any]) -> Any:
    """The tree `tree_flatten` took apart, with `leaves` in its leaves'
    places."""
    return tree_map(lambda i: leaves[i], structure)
