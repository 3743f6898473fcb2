"""The dense decoder of the port: layers, attention, the transformer and
the orthogonality helpers."""
