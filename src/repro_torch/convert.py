"""Load the JAX package's weights and optimizer states into the port.

The JAX side hands over plain numpy arrays, so this module imports
neither package's arrays: a caller converts with ``np.asarray`` and both
packages then compute the same step from the same state. Tree order is
shared (dict keys sorted, sequences in order), so a state's leaves in
``jax.tree.leaves`` order are the port's in ``tree.leaves`` order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import tree
from ._device import resolve_device
from .core.api import ConstraintSet, GroupedDistances, OrthoState
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
    numpy arrays:

    * ``stacks``: the JAX ``ConstraintSet.stacks``, one per group;
    * ``count``: ``OrthoState.count``;
    * ``last_distance``: ``OrthoState.last_distance.per_group``;
    * ``base_state``: every leaf of ``OrthoState.base_state`` in
      ``jax.tree.leaves`` order (e.g. ``count, mu stacks, nu stacks`` of
      a ``ScaleByAdamState``; a chain's links one after another). The
      port's base state has the same leaves in the same order.

    ``base_optimizer`` is the port's counterpart of the JAX base optimizer.
    The state is the same for POGO and Landing: neither keeps extras.
    """
    cs = ConstraintSet.from_tree(params, device=device)
    dev = cs.stacks[0].device if cs.stacks else torch.device(device)

    def tensor(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    cs = ConstraintSet(cs.plan, [tensor(s) for s in arrays["stacks"]])
    base_state = base_optimizer.init(cs) if base_optimizer is not None else ()
    dst = tree.leaves(base_state)
    src = arrays.get("base_state", [])
    if len(src) != len(dst):
        raise ValueError(
            f"the JAX base state has {len(src)} leaves, the port's "
            f"{len(dst)}: the base optimizers differ"
        )
    for d, a in zip(dst, src):
        if tuple(d.shape) != np.shape(a):
            raise ValueError(f"base-state leaf of shape {np.shape(a)} where "
                             f"the port has {tuple(d.shape)}")
        d.copy_(tensor(a))
    state = OrthoState(
        count=tensor(arrays["count"], torch.int32),
        base_state=base_state,
        rng=tensor(arrays.get("rng", (0, 0)), torch.int64),
        last_distance=GroupedDistances(
            plan=cs.stacked_plan(),
            per_group=tuple(tensor(d, torch.float32)
                            for d in arrays["last_distance"]),
        ),
    )
    return cs, state


def params_from_jax(numpy_tree, *, device="cuda"):
    """A JAX param tree of numpy arrays (``jax.tree.map(np.asarray,
    params)``) as the port's tree of tensors on ``device``."""
    device = resolve_device(device)
    return tree.tree_map(
        lambda a: torch.as_tensor(np.array(a), device=device), numpy_tree)


def train_state_from_jax(leaves, like):
    """``like`` (a port tree: an optimizer state, or ``(params,
    opt_state)``) filled with ``leaves``, the numpy leaves of the JAX
    package's counterpart in ``jax.tree.leaves`` order, each cast to the
    port leaf's dtype and device (e.g. the uint32 PRNG key to int64)."""
    dst, td = tree.flatten(like)
    if len(leaves) != len(dst):
        raise ValueError(f"the JAX state has {len(leaves)} leaves, the port's "
                         f"{len(dst)}: the optimizers differ")
    out = []
    for i, (a, d) in enumerate(zip(leaves, dst)):
        a = np.asarray(a)
        if tuple(d.shape) != a.shape:
            raise ValueError(f"leaf {i}: JAX shape {a.shape}, port {tuple(d.shape)}")
        out.append(torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)
                   .to(device=d.device, dtype=d.dtype))
    return tree.unflatten(td, out)


def cache_from_jax(numpy_tree, like):
    """A serving cache of the JAX package (``init_cache``/``init_paged_cache``
    trees after ``jax.tree.map(np.asarray, ...)``) as the port's: ``like``
    is the port's cache of the same shapes (``transformer.init_cache`` or
    ``init_paged_cache``), and each leaf takes its dtype and device (bf16
    leaves come through fp32, exactly)."""
    leaves = []
    for a in tree.leaves(numpy_tree):
        a = np.array(a)  # a writable copy: the port writes caches in place
        leaves.append(a.astype(np.float32) if a.dtype.name == "bfloat16" else a)
    return train_state_from_jax(leaves, like)
