"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
(the port's copy of ``repro.configs.smollm_360m``)."""

from .base import ModelConfig


def config(**overrides) -> ModelConfig:
    kw = dict(
        name="smollm-360m",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        block_pattern=("attn",),
        ortho_families=("attn_qk",),
    )
    kw.update(overrides)
    return ModelConfig(**kw)
