"""Base optimizers: SGD / momentum / Adam / AdamW / VAdam.

Same rules and state layout as ``repro.optim.alias``. Momentum (trace) and
VAdam are linear in the gradient, so the fused group step replays them
in-kernel; Adam is not (elementwise normalisation), so an orthoptimizer
over Adam takes the two-stage path. VAdam's ``nu`` holds one scalar per
matrix, of shape ``lead dims``, so state maps 1:1 from JAX.

Every stateful transform has an ``update_inplace`` that writes the new
moments over the old ones (``optim.transform``); ``update`` clones the
moments first and then runs the same operations, so both give the same
bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tree
from ..distributed.shard_hints import is_dtensor
from .transform import (
    GradientTransformation,
    chain,
    scale_by_learning_rate,
)


def _moments(moments, inplace):
    """The moment tree to overwrite: the state's own, or a copy of it."""
    return moments if inplace else tree.tree_map(torch.clone, moments)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    t = count.to(torch.float32)
    return 1 - torch.pow(torch.tensor(decay, dtype=torch.float32, device=t.device), t)


def _with_inplace(init, step, tag=None) -> GradientTransformation:
    """A transform whose ``update``/``update_inplace`` are ``step`` with
    ``inplace`` False/True."""

    def update(updates, state, params=None):
        return step(updates, state, False)

    def update_inplace(updates, state, params=None):
        return step(updates, state, True)

    return GradientTransformation(init, update, tag=tag,
                                  update_inplace=update_inplace)


class TraceState(NamedTuple):
    momentum: object  # pytree of tensors like params


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """Momentum accumulator (linear in the gradient history)."""

    def init(params):
        return TraceState(momentum=tree.tree_map(torch.zeros_like, params))

    def step(updates, state, inplace):
        new_m = tree.tree_map(lambda m, u: m.mul_(decay).add_(u),
                              _moments(state.momentum, inplace), updates)
        if nesterov:
            out = tree.tree_map(lambda m, u: decay * m + u, new_m, updates)
        else:
            out = new_m
        return out, TraceState(momentum=new_m)

    return _with_inplace(init, step, tag=("trace", decay, nesterov))


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: object
    nu: object


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    """Adam's bias-corrected ``(m / c1) / (sqrt(v / c2) + eps)``,
    elementwise (not linear in the gradient: no fused form)."""

    def init(params):
        leaves = tree.leaves(params)
        device = leaves[0].device if leaves else None
        mu = tree.tree_map(torch.zeros_like, params)
        nu = tree.tree_map(
            lambda p: torch.zeros_like(p, dtype=p.real.dtype), params)
        count = torch.zeros((), dtype=torch.int32, device=device)
        return ScaleByAdamState(count=count, mu=mu, nu=nu)

    def step(updates, state, inplace):
        count = state.count + 1
        mu = tree.tree_map(lambda m, g: m.mul_(b1).add_((1 - b1) * g),
                           _moments(state.mu, inplace), updates)
        nu = tree.tree_map(lambda v, g: v.mul_(b2).add_((1 - b2) * g.abs() ** 2),
                           _moments(state.nu, inplace), updates)
        c1 = _bias_correction(b1, count)
        c2 = _bias_correction(b2, count)
        out = tree.tree_map(
            lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps).to(m.dtype), mu, nu)
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return _with_inplace(init, step)


class ScaleByVAdamState(NamedTuple):
    count: torch.Tensor
    mu: object
    nu: object  # scalar second moment per matrix (shape = lead dims)


def _scalar_moment(p):
    """Zeros of one fp32 scalar per matrix of ``p`` (its lead dims). For a
    ``DTensor`` leaf (the tensor-parallel step), a ``DTensor`` on the same
    mesh, split as ``p``'s lead dims are and replicated where ``p`` splits
    a matrix dim, so every rank holds the scalars of its own matrices."""
    shape = tuple(p.shape[:-2]) if p.ndim >= 2 else ()
    if is_dtensor(p):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor import zeros as dzeros

        placements = [pl if isinstance(pl, Shard) and pl.dim % p.ndim < len(shape)
                      else Replicate() for pl in p.placements]
        return dzeros(shape, dtype=torch.float32, device_mesh=p.device_mesh,
                      placements=placements)
    return torch.zeros(shape, dtype=torch.float32, device=p.device)


def scale_by_vadam(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    """VAdam (Ling et al. 2022): Adam normalised by a per-matrix scalar
    second moment, ``G = (m / c1) / (sqrt(||g||^2_ema / c2) + eps)`` —
    linear in the gradient, hence fusable with POGO."""

    def _sq_norm(g):
        if g.ndim >= 2:
            return torch.sum(g.abs() ** 2, dim=(-2, -1))
        return torch.sum(g.abs() ** 2)

    def init(params):
        leaves = tree.leaves(params)
        device = leaves[0].device if leaves else None
        mu = tree.tree_map(torch.zeros_like, params)
        nu = tree.tree_map(_scalar_moment, params)
        count = torch.zeros((), dtype=torch.int32, device=device)
        return ScaleByVAdamState(count=count, mu=mu, nu=nu)

    def step(updates, state, inplace):
        count = state.count + 1
        mu = tree.tree_map(lambda m, g: m.mul_(b1).add_((1 - b1) * g),
                           _moments(state.mu, inplace), updates)
        nu = tree.tree_map(
            lambda v, g: v.mul_(b2).add_((1 - b2) * _sq_norm(g).to(v.dtype)),
            _moments(state.nu, inplace), updates,
        )
        c1 = _bias_correction(b1, count)
        c2 = _bias_correction(b2, count)

        def norm(m, v):
            denom = torch.sqrt(v / c2) + eps
            if m.ndim >= 2:
                denom = denom[..., None, None]
            return (m / c1) / denom

        return tree.tree_map(norm, mu, nu), ScaleByVAdamState(count=count, mu=mu, nu=nu)

    return _with_inplace(init, step, tag=("vadam", b1, b2, eps))


class AddDecayedWeightsState(NamedTuple):
    pass


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """``u + weight_decay * params`` (AdamW's decoupled decay)."""

    def init(params):
        return AddDecayedWeightsState()

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights requires params")
        updates = tree.tree_map(
            lambda u, p: u + weight_decay * p.to(u.dtype), updates, params)
        return updates, state

    return GradientTransformation(init, update, update_inplace=update)


def sgd(learning_rate, momentum: float = 0.0, nesterov: bool = False) -> GradientTransformation:
    parts = []
    if momentum:
        parts.append(trace(momentum, nesterov))
    parts.append(scale_by_learning_rate(learning_rate))
    return chain(*parts)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(learning_rate))


def adamw(
    learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01
) -> GradientTransformation:
    return chain(
        scale_by_adam(b1, b2, eps),
        add_decayed_weights(weight_decay),
        scale_by_learning_rate(learning_rate),
    )
