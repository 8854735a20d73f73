"""Data & storage layer: the bucket fetch the `gs://` checkpoint loader
uses (copies of the JAX package's `data/` names it reaches)."""
