"""Metrics registry and request tracing (copies of the JAX-free modules
of skypilot_tpu/server/)."""
