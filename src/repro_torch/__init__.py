"""PyTorch/CUDA port of the POGO orthoptimizer (``repro`` is the JAX
reference). Imports torch only, never jax or ``repro``."""
