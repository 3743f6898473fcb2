"""Model configuration: the port's own copy of the fields of
``repro.configs.base.ModelConfig`` that its slices read."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int = 0  # default d_model // num_heads
    block_pattern: tuple = ("attn",)
    ortho_families: tuple = ("attn_qk",)

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
