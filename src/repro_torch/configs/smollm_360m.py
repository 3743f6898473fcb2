"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
(the port's copy of ``repro.configs.smollm_360m``)."""

from .base import ModelConfig


def config(**overrides) -> ModelConfig:
    kw = dict(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        block_pattern=("attn",),
        mlp_activation="swiglu",
        tie_embeddings=True,
        ortho_families=("attn_qk",),
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return config(
        name="smollm-360m-smoke", num_layers=4, d_model=120, num_heads=3,
        num_kv_heads=1, d_ff=320, vocab_size=512, loss_chunk=16, remat="none",
    )
