"""Constraint-group scheduling: bucket param leaves into stacked groups.

Port of ``repro.core.schedule`` for ``grouping="auto"`` (one group per
``(manifold shape, dtype)`` bucket) and ``"per_leaf"`` (one group per
leaf). Tall leaves (p > n) enter transposed, so every group is wide.
Padded megagroups (``"padded"``) are a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

GROUPINGS = ("auto", "per_leaf")


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


def plan_groups(leaves, treedef, grouping: str = "auto") -> GroupPlan:
    """Bucket flat param ``leaves`` (tensors ``(..., p0, n0)``) into
    :class:`GroupSpec` batches, in first-appearance order with members in
    flat-leaf order — the same plan ``repro.core.schedule.plan_groups``
    makes for the same tree."""
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
