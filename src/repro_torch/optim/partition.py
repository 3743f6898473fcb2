"""Label-based optimizer partitioning (``repro.optim.partition``).

The trainer splits the parameter tree by label: ``"orthogonal"`` leaves
(the Stiefel stacks ``models.ortho`` selects) get the orthoptimizer,
``"default"`` leaves AdamW. Each inner transform sees its own flat tuple
of leaves; for the orthoptimizer that tuple is what its driver buckets
into constraint groups (one ``(B, p, n)`` stack per shape).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Union

from .. import tree
from .transform import GradientTransformation

PyTree = Any


class PartitionState(NamedTuple):
    inner_states: dict  # {label: inner state}


def _resolve(labels, params, transforms):
    lab = labels(params) if callable(labels) else labels
    lab_flat, lab_def = tree.flatten(lab)
    p_flat, p_def = tree.flatten(params)
    if lab_def != p_def:
        raise ValueError(f"label structure {lab_def} != param structure {p_def}")
    for name in lab_flat:
        if name not in transforms:
            raise ValueError(f"label {name!r} has no transform (have {list(transforms)})")
    return lab_flat, p_flat


def partition(transforms: Mapping[str, GradientTransformation],
              labels: Union[PyTree, Callable[[PyTree], PyTree]]) -> GradientTransformation:
    """One transform per label; the tag carries the transforms by label."""
    names = tuple(transforms)

    def init(params):
        lab_flat, p_flat = _resolve(labels, params, transforms)
        return PartitionState(inner_states={
            name: transforms[name].init(
                tuple(p for p, lab in zip(p_flat, lab_flat) if lab == name))
            for name in names})

    def update(grads, state, params=None):
        ref = params if params is not None else grads
        lab_flat, _ = _resolve(labels, ref, transforms)
        g_flat, g_def = tree.flatten(grads)
        p_flat = tree.leaves(params) if params is not None else None
        out_flat = list(g_flat)
        new_states = {}
        for name in names:
            idx = [i for i, lab in enumerate(lab_flat) if lab == name]
            sub_p = tuple(p_flat[i] for i in idx) if p_flat is not None else None
            upd, new_states[name] = transforms[name].update(
                tuple(g_flat[i] for i in idx), state.inner_states[name], sub_p)
            for i, u in zip(idx, upd):
                out_flat[i] = u
        return tree.unflatten(g_def, out_flat), PartitionState(new_states)

    return GradientTransformation(init, update, tag=("partition", dict(transforms)))
