"""Device selection for the package's entry points.

Entry points run on the GPU unless the caller names another device: no
device means CUDA, and with no CUDA device that is an error, never a
silent fall back to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> the current CUDA device (raises without one); 'cuda' is
    pinned to the current device index so device comparisons are exact."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device available; pass device="cpu" to run on the '
                'CPU explicitly')
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    return dev


def device_of(module: torch.nn.Module) -> Optional[torch.device]:
    """The device every parameter of `module` lives on (None if it has
    none); raises when they are split across devices."""
    devices = {p.device for p in module.parameters()}
    if len(devices) > 1:
        raise ValueError(f'parameters span several devices: {devices}')
    return next(iter(devices), None)
