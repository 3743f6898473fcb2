"""Minimal optax-style optimizer protocol on tensors.

Mirrors ``repro.optim.transform``: a ``GradientTransformation`` is
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; ``chain`` composes left to right. The structural ``tag`` lets
``optim.fused.resolve_fused_base`` recognise a base optimizer the fused
kernel replays in-kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

from .. import tree

PyTree = Any


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, Optional[PyTree]], tuple[PyTree, PyTree]]
    # Structural tag for transforms the fused group step can replay
    # in-kernel (optim/fused.py); None means opaque.
    tag: Any = None
    # Orthoptimizers only: ``(params, state, grads) -> state`` that writes
    # the new iterate into ``params`` and the moments into ``state`` in
    # place (``core.api.constraint_step``).
    update_inplace: Optional[Callable] = None


class EmptyState(NamedTuple):
    pass


def identity() -> GradientTransformation:
    def init(params):
        return EmptyState()

    def update(updates, state, params=None):
        return updates, state

    return GradientTransformation(init, update, tag=("identity",))


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update, tag=("chain", tuple(transforms)))


def scale(factor: float) -> GradientTransformation:
    def init(params):
        return EmptyState()

    def update(updates, state, params=None):
        return tree.tree_map(lambda u: factor * u, updates), state

    return GradientTransformation(init, update, tag=("scale", factor))
