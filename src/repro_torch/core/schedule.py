"""Constraint-group scheduling: bucket param leaves into stacked groups.

Port of ``repro.core.schedule`` for ``grouping="auto"`` (one group per
``(manifold shape, dtype)`` bucket) and ``"per_leaf"`` (one group per
leaf). Tall leaves (p > n) enter transposed, so every group is wide.
Padded megagroups (``"padded"``) are a later slice. :class:`TpSpec` and
:func:`tp_spec` plan the tensor-parallel split of a group's n axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

GROUPINGS = ("auto", "per_leaf")
# A TP shard's local column count rounds up to 4 floats (16 bytes), so that
# every row of a shard's padded block starts 16-byte aligned and the
# kernels take their float4 path. (The JAX package rounds to the TPU's
# 128-lane tile there and to 1 off the TPU.)
_LANE = 4


@dataclasses.dataclass(frozen=True)
class GroupMember:
    """One leaf's slot in a :class:`GroupSpec` batch: flat leaf index,
    leading stack dims, whether it enters transposed, its first row in the
    stacked ``(B, p, n)`` tensor, its first global matrix id, and its true
    manifold-orientation shape."""

    leaf: int
    lead: tuple[int, ...]
    transpose: bool
    offset: int
    key_base: int
    p: int
    n: int

    @property
    def count(self) -> int:
        return math.prod(self.lead)


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One constraint group: a batched ``(B, p, n)`` dispatch whose members
    share the manifold-orientation shape and dtype (no ragged groups in
    this slice)."""

    p: int
    n: int
    dtype: Any  # torch.dtype
    members: tuple[GroupMember, ...]
    batch: int


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """Bucketing of a param tree into constraint groups. A tree node with
    no leaves (JAX's static node), so states that carry a plan flatten to
    the same leaves in both packages."""

    groups: tuple[GroupSpec, ...]
    treedef: Any
    n_leaves: int
    n_matrices: int

    def tree_flatten(self):
        return (), self

    @classmethod
    def tree_unflatten(cls, aux, children):
        return aux


def padded_n(n: int, tp_shards: int = 1) -> int:
    """``n`` at the TP schedule's padding granularity
    (``repro/core/schedule.py:235``): unchanged without TP; under TP every
    shard's local column count rounds up to a multiple of 4."""
    if tp_shards <= 1:
        return n
    local = -(-n // tp_shards)
    return (local + _LANE - 1) // _LANE * _LANE * tp_shards


@dataclasses.dataclass(frozen=True)
class TpSpec:
    """Static n-axis split of one constraint group
    (``repro/core/schedule.py:293``): ``width`` ranks along ``axis`` each
    own ``local_n`` columns of the group's stack, zero-padded from the
    true ``n`` to ``n_pad = width * local_n``. Zero columns are exactly
    inert through the TP algebra: they add nothing to any gram partial and
    get exact zeros back from the column-local finish, so the driver pads
    before the step and crops after."""

    width: int
    axis: str
    n: int
    n_pad: int
    local_n: int

    @property
    def padded(self) -> bool:
        return self.n_pad != self.n


def tp_spec(n: int, width: int, axis: str = "model") -> Optional[TpSpec]:
    """TP plan for a group of ``n`` columns over ``width`` ranks
    (``repro/core/schedule.py:316``), or ``None`` when TP cannot help
    (width < 2, or so few columns that a shard would own only padding)."""
    if width < 2:
        return None
    n_pad = padded_n(n, width)
    local = n_pad // width
    if local * (width - 1) >= n:  # some shard would be pure padding
        return None
    return TpSpec(width=width, axis=axis, n=n, n_pad=n_pad, local_n=local)


def plan_groups(leaves, treedef, grouping: str = "auto",
                tp_shards: int = 1) -> GroupPlan:
    """Bucket flat param ``leaves`` (tensors ``(..., p0, n0)``) into
    :class:`GroupSpec` batches, in first-appearance order with members in
    flat-leaf order — the same plan ``repro.core.schedule.plan_groups``
    makes for the same tree. ``tp_shards`` is the mesh's TP width, as the
    JAX driver passes it (``repro/core/api.py:1223-1225``); only the
    padded megagroup cost model reads it there, so the two groupings here
    do not depend on it."""
    if tp_shards < 1:
        raise ValueError(f"tp_shards must be >= 1, got {tp_shards}")
    if grouping not in GROUPINGS:
        raise NotImplementedError(
            f"grouping {grouping!r} is not ported (have {GROUPINGS}; "
            "ROADMAP: ragged megagroups)"
        )
    buckets: dict = {}
    order: list = []
    key_base = 0
    for i, x in enumerate(leaves):
        if x.ndim < 2:
            raise ValueError(
                f"orthoptimizer leaves must be matrices (..., p, n); leaf {i} "
                f"has shape {tuple(x.shape)}"
            )
        p0, n0 = x.shape[-2], x.shape[-1]
        transpose = p0 > n0
        p, n = (n0, p0) if transpose else (p0, n0)
        lead = tuple(x.shape[:-2])
        count = math.prod(lead)
        key = (p, n, x.dtype) if grouping == "auto" else ("leaf", i)
        if key not in buckets:
            buckets[key] = {"p": p, "n": n, "dtype": x.dtype, "members": [],
                            "batch": 0}
            order.append(key)
        b = buckets[key]
        b["members"].append(GroupMember(
            leaf=i, lead=lead, transpose=transpose, offset=b["batch"],
            key_base=key_base, p=p, n=n,
        ))
        b["batch"] += count
        key_base += count
    groups = tuple(
        GroupSpec(p=b["p"], n=b["n"], dtype=b["dtype"],
                  members=tuple(b["members"]), batch=b["batch"])
        for b in (buckets[k] for k in order)
    )
    return GroupPlan(groups=groups, treedef=treedef, n_leaves=len(leaves),
                     n_matrices=key_base)
