"""Which weights of a model live on St(p, n), without building the model.

Port of the ``attn_qk`` family of ``repro.models.ortho``: the per-head
query and key projections, stacked over layers as the JAX model scans
them, ``q_proj (L, H, head_dim, d_model)`` and ``k_proj (L, KV, head_dim,
d_model)`` — wide Stiefel matrices.
"""

from __future__ import annotations

from ..configs.base import ModelConfig


def orthogonal_leaf_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """``{name: shape}`` of the constrained leaves of ``cfg``'s model."""
    if "attn_qk" not in cfg.ortho_families:
        raise NotImplementedError(
            f"ortho families {cfg.ortho_families} are not ported "
            "(ROADMAP: models + training stack)"
        )
    if set(cfg.block_pattern) != {"attn"}:
        raise NotImplementedError(
            f"block pattern {cfg.block_pattern} is not ported "
            "(ROADMAP: models + training stack)"
        )
    lead, hd, d = cfg.num_layers, cfg.head_dim, cfg.d_model
    return {
        "q_proj": (lead, cfg.num_heads, hd, d),
        "k_proj": (lead, cfg.num_kv_heads, hd, d),
    }
