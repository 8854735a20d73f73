"""Serving: the continuous-batching decode engine and its HTTP server."""
from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig

__all__ = ['DecodeEngine', 'EngineConfig']
