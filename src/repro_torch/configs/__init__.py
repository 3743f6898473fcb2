"""Model configurations the port supports (its own copies)."""

from . import smollm_360m
from .base import ModelConfig

ARCHS = {"smollm-360m": smollm_360m}
# The JAX package's other architectures (MoE, SSM, RG-LRU, VLM, audio,
# encoder-decoder) wait for their model families.
_NOT_PORTED = (
    "granite-20b", "starcoder2-15b", "internlm2-1.8b", "recurrentgemma-2b",
    "falcon-mamba-7b", "granite-moe-1b-a400m", "mixtral-8x22b", "internvl2-1b",
    "seamless-m4t-large-v2",
)


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP: models + training stack)")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    mod = ARCHS[arch]
    return mod.smoke_config() if smoke else mod.config(**overrides)


__all__ = ["ARCHS", "ModelConfig", "get_config", "smollm_360m"]
