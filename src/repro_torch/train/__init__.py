"""The training step and loop of the port."""
