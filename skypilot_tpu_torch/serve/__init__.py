"""Serving-side helpers the port shares with the JAX package's serve
plane (copies of its JAX-free modules)."""
