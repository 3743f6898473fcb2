"""Device mesh and the tensor-parallel group schedule (``shard_hints``)."""
