"""Load the JAX package's constraint-step state into the port.

The JAX side hands over plain numpy arrays, so this module imports
neither package's arrays: a caller converts with ``np.asarray`` and both
packages then compute the same step from the same state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.api import ConstraintSet, GroupedDistances, OrthoState
from .optim import fused as optim_fused
from .optim.transform import GradientTransformation


def state_from_jax(
    params,
    arrays: dict,
    base_optimizer: Optional[GradientTransformation] = None,
    *,
    device="cuda",
) -> tuple[ConstraintSet, OrthoState]:
    """Build the port's ``(ConstraintSet, OrthoState)`` from a JAX state.

    ``params`` is the param tree both sides stacked with
    ``grouping="auto"`` (its shapes fix the group plan). ``arrays`` holds
    numpy arrays, one entry per constraint group where a list is asked for:

    * ``stacks``: the JAX ``ConstraintSet.stacks``;
    * ``count``: ``OrthoState.count``;
    * ``last_distance``: ``OrthoState.last_distance.per_group``;
    * ``mu``, ``nu``, ``base_count``: the base optimizer's moment stacks,
      per-matrix second moments and step counter, where it has them
      (``repro.optim.fused.resolve_fused_base(base).get_slots``).

    ``base_optimizer`` is the port's counterpart of the JAX base optimizer.
    """
    cs = ConstraintSet.from_tree(params, device=device)
    dev = cs.stacks[0].device if cs.stacks else torch.device(device)

    def tensor(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    cs = ConstraintSet(cs.plan, [tensor(s) for s in arrays["stacks"]])
    base_state = base_optimizer.init(cs) if base_optimizer is not None else ()
    fused_base = optim_fused.resolve_fused_base(base_optimizer)
    if fused_base is None:
        raise ValueError("the base optimizer has no fused slot layout")
    mu_tree, nu_tree, base_count = fused_base.get_slots(base_state)
    if mu_tree is not None:
        for dst, src in zip(mu_tree.stacks, arrays["mu"]):
            dst.copy_(tensor(src))
    if nu_tree is not None:
        for dst, src in zip(nu_tree.stacks, arrays["nu"]):
            dst.copy_(tensor(src))
    if base_count is not None:
        base_count.fill_(int(np.asarray(arrays["base_count"])))
    state = OrthoState(
        count=tensor(arrays["count"], torch.int32),
        base_state=base_state,
        rng=0,
        last_distance=GroupedDistances(
            plan=cs.stacked_plan(),
            per_group=tuple(tensor(d, torch.float32)
                            for d in arrays["last_distance"]),
        ),
    )
    return cs, state
