"""Nested containers of tensors, walked in the JAX package's pytree order.

A tree is a dict, list or tuple whose leaves are tensors (or arrays);
``None`` is an empty node, as in JAX, and has no leaf.  Dict keys are
visited in sorted order and sequences by index, which is the order
``jax.tree_util.tree_flatten_with_path`` gives: a checkpoint's leaf keys
and the optimizer's state line up with the JAX package's.  A path is the
tuple of keys (dict keys, sequence indices) from the root to a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _children(node) -> Iterator[tuple[Any, Any]]:
    if isinstance(node, dict):
        for k in sorted(node):
            yield k, node[k]
    else:
        yield from enumerate(node)


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


# The walks are module-level functions, not closures that call themselves:
# such a closure is a reference cycle, and it would keep what it captured
# (a list of leaves, a mapped function's tensors) alive until the cyclic
# garbage collector ran, a step's gradients of a 2 GB table among them.
def _collect(node, path: tuple, out: list) -> None:
    if node is None:
        return
    if _is_node(node):
        for k, child in _children(node):
            _collect(child, path + (k,), out)
    else:
        out.append((path, node))


def leaves_with_path(tree) -> list[tuple[tuple, Any]]:
    """(path, leaf) for every leaf, in pytree order; ``None`` is skipped."""
    out: list = []
    _collect(tree, (), out)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def _map(fn: Callable, node, others: list, path: tuple):
    if node is None:
        return None
    if _is_node(node):
        built = {k: _map(fn, child, [o[k] for o in others], path + (k,))
                 for k, child in _children(node)}
        if isinstance(node, dict):
            return {k: built[k] for k in node}
        return type(node)(built[i] for i in range(len(node)))
    return fn(path, node, *others)


def map_with_path(fn: Callable, tree, *rest):
    """A tree of ``fn(path, leaf, *leaves of rest at that path)`` in the
    structure of ``tree``; ``None`` stays ``None``.  ``rest`` must hold
    every path of ``tree``."""
    return _map(fn, tree, list(rest), ())


def tree_map(fn: Callable, tree, *rest):
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def unflatten(like, new_leaves: list):
    """``like``'s structure with its leaves replaced, in pytree order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def key_of(path: tuple, sep: str = "/") -> str:
    """A path as the JAX package's checkpoint names it: keys joined by
    ``sep``."""
    return sep.join(str(k) for k in path)


def get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree
