"""Trees of tensors: nested dicts, lists, tuples, dataclasses and `None`
with tensors (or any other values) at the leaves, walked in
`jax.tree.flatten`'s order: a dict's keys sorted, a list's or tuple's items
in order, a dataclass's fields in declaration order, and `None` an empty
subtree with no leaf.  The port's param dicts, its `AdamWState` and its
checkpoints (utils/checkpoint.py) share this order with the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List


def _is_dataclass(node) -> bool:
    return dataclasses.is_dataclass(node) and not isinstance(node, type)


# Module-level recursion: a nested function that calls itself sits in a
# reference cycle with its closure, which would keep the leaves it holds
# (gradients, say) alive until the garbage collector runs.
def _flatten(node, leaves: List[Any]) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten(node[k], leaves)
    elif isinstance(node, (list, tuple)):
        for x in node:
            _flatten(x, leaves)
    elif _is_dataclass(node):
        for f in dataclasses.fields(node):
            _flatten(getattr(node, f.name), leaves)
    else:
        leaves.append(node)


def tree_flatten(tree: Any) -> List[Any]:
    """The leaves of `tree` in jax.tree.flatten's order."""
    leaves: List[Any] = []
    _flatten(tree, leaves)
    return leaves


def _build(node, it: Iterator[Any]) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        out = {k: _build(node[k], it) for k in sorted(node)}
        return {k: out[k] for k in node}  # the template's key order
    if isinstance(node, (list, tuple)):
        return type(node)(_build(x, it) for x in node)
    if _is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: _build(getattr(node, f.name), it)
            for f in dataclasses.fields(node)})
    return next(it)


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """A tree shaped as `template` with its leaves taken from `leaves` in
    tree_flatten's order (the template's own leaf values are ignored)."""
    return _build(template, iter(leaves))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` applied leaf by leaf to `tree` and the trees of the same shape
    in `rest`; the result has `tree`'s shape."""
    leaves = [tree_flatten(t) for t in (tree,) + rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])
