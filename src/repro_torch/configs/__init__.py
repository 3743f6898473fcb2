"""Model configurations the port supports (its own copies)."""

from . import smollm_360m
from .base import ModelConfig

__all__ = ["ModelConfig", "smollm_360m"]
