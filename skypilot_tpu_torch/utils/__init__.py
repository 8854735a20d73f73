"""Utilities (copies of the JAX-free modules of skypilot_tpu/utils/)."""
