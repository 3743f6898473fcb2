"""Which weights live on St(p, n), their init projection, and the
optimizer label tree (``repro.models.ortho``).

``ortho_families`` in the config selects the families; the port has the
``attn_qk`` family: the per-head query and key projections, stacked
``(L, H, head_dim, d_model)`` wide Stiefel matrices. ``label_tree``
returns "orthogonal"/"default" per leaf for ``optim.partition``;
``project_init`` projects the selected leaves onto the manifold with the
plain Newton-Schulz iteration (20 iterations), as the JAX package does.
"""

from __future__ import annotations

from typing import Any

import torch

from .. import tree
from ..configs.base import ModelConfig
from ..core import stiefel

PyTree = Any
_NOT_PORTED = "models + training stack"


def _check_families(cfg) -> None:
    if set(cfg.ortho_families) - {"attn_qk"}:
        raise NotImplementedError(
            f"ortho families {cfg.ortho_families} are not ported "
            f"(ROADMAP: {_NOT_PORTED})")


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _is_orthogonal_path(path_s: str, cfg) -> bool:
    _check_families(cfg)
    return "attn_qk" in cfg.ortho_families and (
        "q_proj" in path_s or "k_proj" in path_s)


def _flags(params, cfg) -> list:
    return [_is_orthogonal_path(_path_str(p), cfg)
            for p, _ in tree.flatten_with_path(params)]


def label_tree(params: PyTree, cfg) -> PyTree:
    """'orthogonal' / 'default' with the same structure as params."""
    td = tree.flatten(params)[1]
    return tree.unflatten(td, ["orthogonal" if f else "default"
                               for f in _flags(params, cfg)])


def orthogonal_leaf_info(params: PyTree, cfg) -> list:
    """``[(path_str, shape)]`` of the constrained leaves."""
    return [(_path_str(p), tuple(x.shape)) for p, x in tree.flatten_with_path(params)
            if _is_orthogonal_path(_path_str(p), cfg)]


def orthogonal_leaf_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """``{name: shape}`` of the constrained leaves of ``cfg``'s model,
    without building it."""
    _check_families(cfg)
    if set(cfg.block_pattern) != {"attn"}:
        raise NotImplementedError(
            f"block pattern {cfg.block_pattern} is not ported "
            f"(ROADMAP: {_NOT_PORTED})")
    lead, hd, d = cfg.num_layers, cfg.head_dim, cfg.d_model
    return {
        "q_proj": (lead, cfg.num_heads, hd, d),
        "k_proj": (lead, cfg.num_kv_heads, hd, d),
    }


def extract_constrained(params: PyTree, cfg) -> tuple:
    """The constrained leaves in flatten order (the order ``label_tree`` and
    ``optim.partition`` hand them to the orthoptimizer)."""
    return tuple(x for x, f in zip(tree.leaves(params), _flags(params, cfg)) if f)


def merge_constrained(params: PyTree, cfg, leaves) -> PyTree:
    """Write ``leaves`` (as :func:`extract_constrained` gives them) back into
    the constrained positions of ``params``; shape or count mismatches
    raise."""
    td = tree.flatten(params)[1]
    it = iter(leaves)
    out = []
    for (path, leaf), f in zip(tree.flatten_with_path(params), _flags(params, cfg)):
        if not f:
            out.append(leaf)
            continue
        ps = _path_str(path)
        try:
            new = next(it)
        except StopIteration:
            raise ValueError(f"merge_constrained: ran out of leaves at {ps!r}") from None
        if tuple(new.shape) != tuple(leaf.shape):
            raise ValueError(f"merge_constrained: {ps!r} expects "
                             f"{tuple(leaf.shape)}, got {tuple(new.shape)}")
        out.append(new.to(leaf.dtype))
    leftover = sum(1 for _ in it)
    if leftover:
        raise ValueError(f"merge_constrained: {leftover} extra leaves")
    return tree.unflatten(td, out)


def _project_leaf(leaf: torch.Tensor) -> torch.Tensor:
    """Project ``(..., p, n)`` onto St; tall matrices along the transpose."""
    p, n = leaf.shape[-2:]
    x = leaf.float() if p <= n else leaf.transpose(-1, -2).float()
    y = stiefel.project_newton_schulz(x, iters=20)
    return (y if p <= n else y.transpose(-1, -2)).to(leaf.dtype).contiguous()


def project_init(params: PyTree, cfg) -> PyTree:
    """Project every constrained leaf onto its Stiefel manifold."""
    td = tree.flatten(params)[1]
    return tree.unflatten(td, [_project_leaf(x) if f else x
                               for x, f in zip(tree.leaves(params), _flags(params, cfg))])


def max_manifold_distance(params: PyTree, cfg) -> torch.Tensor:
    """Max ``||X X^T - I||_F`` over the constrained leaves."""
    dists = []
    for x in extract_constrained(params, cfg):
        x = x.float()
        if x.shape[-2] > x.shape[-1]:
            x = x.transpose(-1, -2)
        dists.append(stiefel.manifold_distance(x).max())
    if not dists:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(dists).max()
