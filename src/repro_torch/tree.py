"""Minimal pytree flattening for parameter trees of tensors.

Same leaf order as ``jax.tree.flatten``: dict keys sorted, lists, tuples
and NamedTuples in order, ``None`` an empty subtree. A class with a
``tree_flatten()`` method and a ``tree_unflatten(aux, children)``
classmethod (``ConstraintSet``) is a node too. Keeping JAX's order makes
the port's constraint groups and their members line up with the JAX
package's for the same tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class TreeDef:
    kind: str  # leaf | none | dict | list | tuple | namedtuple | custom
    aux: Any = None
    children: tuple = ()


_LEAF = TreeDef("leaf")


def _node(tree):
    """``(kind, aux, children)`` of a container, or ``None`` for a leaf."""
    if tree is None:
        return "none", None, ()
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return "dict", keys, tuple(tree[k] for k in keys)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return "namedtuple", type(tree), tuple(tree)
    if isinstance(tree, tuple):
        return "tuple", None, tree
    if isinstance(tree, list):
        return "list", None, tuple(tree)
    if hasattr(tree, "tree_flatten") and hasattr(type(tree), "tree_unflatten"):
        children, aux = tree.tree_flatten()
        return "custom", (type(tree), aux), tuple(children)
    return None


def flatten(tree) -> tuple[list, TreeDef]:
    node = _node(tree)
    if node is None:
        return [tree], _LEAF
    kind, aux, children = node
    leaves: list = []
    defs = []
    for child in children:
        sub, d = flatten(child)
        leaves.extend(sub)
        defs.append(d)
    return leaves, TreeDef(kind, aux, tuple(defs))


def flatten_with_path(tree, prefix: tuple = ()) -> list:
    """``[(path, leaf)]`` in :func:`flatten` order; a path holds dict keys
    and sequence indices, as ``jax.tree_util.tree_flatten_with_path``."""
    node = _node(tree)
    if node is None:
        return [(prefix, tree)]
    kind, aux, children = node
    keys = aux if kind == "dict" else range(len(children))
    out: list = []
    for key, child in zip(keys, children):
        out.extend(flatten_with_path(child, prefix + (key,)))
    return out


def _count(td: TreeDef) -> int:
    if td.kind == "leaf":
        return 1
    return sum(_count(c) for c in td.children)


def _build(d: TreeDef, it) -> Any:
    if d.kind == "leaf":
        return next(it)
    if d.kind == "none":
        return None
    children = [_build(c, it) for c in d.children]
    if d.kind == "dict":
        return dict(zip(d.aux, children))
    if d.kind == "namedtuple":
        return d.aux(*children)
    if d.kind == "tuple":
        return tuple(children)
    if d.kind == "list":
        return children
    cls, aux = d.aux
    return cls.tree_unflatten(aux, children)


def unflatten(td: TreeDef, leaves) -> Any:
    # A module-level function: a nested recursive one would sit in a
    # reference cycle with its leaf iterator and keep every leaf alive
    # until the garbage collector runs.
    leaves = list(leaves)
    if len(leaves) != _count(td):
        raise ValueError(f"{len(leaves)} leaves for a tree of {_count(td)}")
    return _build(td, iter(leaves))


def tree_map(fn: Callable, tree, *rest) -> Any:
    leaves, td = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])


def leaves(tree) -> list:
    return flatten(tree)[0]
