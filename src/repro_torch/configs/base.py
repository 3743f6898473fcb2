"""Model configuration: the port's own copy of the fields of
``repro.configs.base.ModelConfig`` that the dense decoder family reads."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # default d_model // num_heads
    family: str = "dense"
    attention_window: Optional[int] = None
    rope_theta: float = 10000.0
    block_pattern: tuple = ("attn",)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    mlp_activation: str = "swiglu"
    vocab_pad_multiple: int = 256
    ortho_families: tuple = ("attn_qk",)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    loss_chunk: int = 512
    remat: str = "full"  # "none" | "full"
    flash_block_q: int = 512
    flash_block_k: int = 512

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def layer_plan(self):
        """``(unit, n_repeats, tail)``: the unit repeats ``n_repeats`` times,
        then the tail's layers (a pattern that does not divide the depth)."""
        unit = tuple(self.block_pattern)
        n_rep = self.num_layers // len(unit)
        tail = tuple(unit[: self.num_layers % len(unit)])
        return unit, n_rep, tail
