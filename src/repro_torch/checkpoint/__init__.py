"""Checkpoints of the port, on the JAX package's on-disk layout."""
