"""The error types the port raises where the JAX package raises its own
(copies of `skypilot_tpu/exceptions.py`'s, pinned in
tests/test_torch_package.py)."""
from __future__ import annotations


class SkyTpuError(Exception):
    """Base class for all framework errors."""


class InvalidTaskError(SkyTpuError):
    """Task YAML / construction is invalid."""


class InvalidSkyConfigError(SkyTpuError):
    """Layered config file failed schema validation."""


class InvalidRequestError(SkyTpuError):
    """API request body failed schema validation (HTTP 400)."""


class StorageError(SkyTpuError):
    """Base storage error."""
