"""Linear base optimizers the fused group step replays: momentum (trace)
and VAdam. Same state layout as ``repro.optim.alias``: ``nu`` holds one
scalar per matrix, of shape ``lead dims``, so state maps 1:1 from JAX."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tree
from .transform import GradientTransformation


class TraceState(NamedTuple):
    momentum: object  # pytree of tensors like params


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """Momentum accumulator (linear in the gradient history)."""

    def init(params):
        return TraceState(momentum=tree.tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        new_m = tree.tree_map(lambda m, u: decay * m + u, state.momentum, updates)
        if nesterov:
            out = tree.tree_map(lambda m, u: decay * m + u, new_m, updates)
        else:
            out = new_m
        return out, TraceState(momentum=new_m)

    return GradientTransformation(init, update, tag=("trace", decay, nesterov))


class ScaleByVAdamState(NamedTuple):
    count: torch.Tensor
    mu: object
    nu: object  # scalar second moment per matrix (shape = lead dims)


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
        nu = tree.tree_map(
            lambda p: torch.zeros(p.shape[:-2] if p.ndim >= 2 else (),
                                  dtype=torch.float32, device=p.device),
            params,
        )
        count = torch.zeros((), dtype=torch.int32, device=device)
        return ScaleByVAdamState(count=count, mu=mu, nu=nu)

    def update(updates, state, params=None):
        count = state.count + 1
        mu = tree.tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, updates)
        nu = tree.tree_map(
            lambda v, g: b2 * v + (1 - b2) * _sq_norm(g).to(v.dtype),
            state.nu, updates,
        )
        t = count.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)

        def norm(m, v):
            denom = torch.sqrt(v / c2) + eps
            if m.ndim >= 2:
                denom = denom[..., None, None]
            return (m / c1) / denom

        return tree.tree_map(norm, mu, nu), ScaleByVAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update, tag=("vadam", b1, b2, eps))
