"""Minimal optax-style optimizer protocol on tensors.

Mirrors ``repro.optim.transform``: a ``GradientTransformation`` is
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; ``chain`` composes left to right. The structural ``tag`` lets
``optim.fused.resolve_fused_base`` recognise a base optimizer the fused
kernel replays in-kernel.

``update`` never modifies its arguments. ``update_inplace``, where a
transform has one, takes and returns the same things but overwrites the
old state's moment tensors with the new moments and hands them back in
the new state, so a step allocates no moment-sized state
(``core.api.constraint_step``). Transforms without moment buffers use
``update`` itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from .. import tree

PyTree = Any


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, Optional[PyTree]], tuple[PyTree, PyTree]]
    # Structural tag for transforms the fused group step can replay
    # in-kernel (optim/fused.py); None means opaque. Orthoptimizers carry
    # ("orthogonal", method name), which no base resolves to.
    tag: Any = None
    # ``update`` that overwrites the state's moment tensors in place (see
    # the module docstring); None where the transform has no such form.
    # Orthoptimizers built by ``core.api.orthogonal`` also write the new
    # iterate over the param stacks and return no updates.
    update_inplace: Optional[Callable] = None


class EmptyState(NamedTuple):
    pass


def identity() -> GradientTransformation:
    def init(params):
        return EmptyState()

    def update(updates, state, params=None):
        return updates, state

    return GradientTransformation(init, update, tag=("identity",),
                                  update_inplace=update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def run(name):
        def update(updates, state, params=None):
            new_state = []
            for t, s in zip(transforms, state):
                updates, s = getattr(t, name)(updates, s, params)
                new_state.append(s)
            return updates, tuple(new_state)

        return update

    inplace = all(t.update_inplace is not None for t in transforms)
    return GradientTransformation(
        init, run("update"), tag=("chain", tuple(transforms)),
        update_inplace=run("update_inplace") if inplace else None,
    )


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf, in each param's dtype."""
    return tree.tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(updates) -> torch.Tensor:
    """``sqrt(sum ||leaf||^2)`` over a tree, in fp32."""
    leaves = tree.leaves(updates)
    return torch.sqrt(sum(torch.sum(x.float().abs() ** 2) for x in leaves))


def scale(factor: float) -> GradientTransformation:
    def init(params):
        return EmptyState()

    def update(updates, state, params=None):
        return tree.tree_map(lambda u: factor * u, updates), state

    return GradientTransformation(init, update, tag=("scale", factor),
                                  update_inplace=update)


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


def scale_by_schedule(schedule: Callable[[torch.Tensor], Any]) -> GradientTransformation:
    """Negated ``schedule(count) * u``, the step counter in the state."""

    def init(params):
        leaves = tree.leaves(params)
        device = leaves[0].device if leaves else None
        return ScaleByScheduleState(
            count=torch.zeros((), dtype=torch.int32, device=device))

    def update(updates, state, params=None):
        s = schedule(state.count)
        updates = tree.tree_map(lambda u: -s * u, updates)
        return updates, ScaleByScheduleState(count=state.count + 1)

    return GradientTransformation(init, update, update_inplace=update)


def scale_by_learning_rate(lr) -> GradientTransformation:
    """Negate-and-scale, accepting a float or a schedule callable."""
    if callable(lr):
        return scale_by_schedule(lr)
    return scale(-lr)
