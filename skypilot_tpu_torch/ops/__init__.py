"""Ops: plain attention and the hand-written flash-forward kernel."""
from skypilot_tpu_torch.ops.attention import flash_attention, mha_reference

__all__ = ['flash_attention', 'mha_reference']
