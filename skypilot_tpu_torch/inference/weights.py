"""Checkpoint loading for serve replicas (PyTorch).

Twin of `skypilot_tpu/inference/weights.py::load_serving_params`: a
training run checkpoints through `train/checkpoint.py` (`step_<n>/
state.pt`, written by `torch.save`), and the serve replica restores the
params at startup.  Train and serve share one state dict (the names
`Llama(cfg, params)` loads), so no conversion step is needed.

Not here yet: `gs://` paths (the JAX package fetches them through its
storage layer, which the port has no copy of) and per-device shardings
(`serving_shardings`, the multi-device slice).  A JAX trainer's orbax
checkpoint is not read: carry JAX weights across in memory with
`models/convert.py::params_from_jax`.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.device import DeviceLike, resolve_device
from skypilot_tpu_torch.train.checkpoint import CheckpointManager

logger = sky_logging.init_logger(__name__)


def load_serving_params(path: str, step: Optional[int] = None,
                        dtype: Optional[torch.dtype] = None,
                        device: DeviceLike = None
                        ) -> Dict[str, torch.Tensor]:
    """The params of checkpoint step `step` (None: the latest) under
    `path`, as the state dict `Llama(cfg, params)` takes, on `device`
    (default: the GPU; raises without one).

    Accepts a full `TrainState` checkpoint (`{'params', 'optimizer',
    'schedule', 'step'}`, train/trainer.py; everything but `params` is
    dropped) or a params-only state dict.  `dtype` casts the floating
    tensors only.  The file is read with `weights_only=True` and memory-
    mapped, so a TrainState's optimizer moments are never read; each
    param is copied to `device` (and cast) one tensor at a time, never
    holding the whole tree twice on the host.
    """
    if path.startswith('gs://'):
        raise ValueError(
            f'{path!r}: gs:// checkpoints come with the storage slice of '
            f'the port (the bucket fetch is not ported); copy the '
            f'checkpoint to a local directory first')
    device = resolve_device(device)
    local = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(local):
        raise FileNotFoundError(f'no checkpoint directory {path!r} '
                                f'(resolved to {local!r})')
    mgr = CheckpointManager(local)
    if step is None:
        step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f'no checkpoint steps found under {path!r} '
                                f'(resolved to {local!r})')
    logger.info(f'restoring checkpoint step {step} from {path}')
    state = torch.load(mgr.state_path(step), map_location='cpu',
                       weights_only=True, mmap=True)
    # TrainState layout: {'params': ..., 'optimizer': ..., ...}
    if isinstance(state, dict) and isinstance(state.get('params'), dict):
        state = state['params']

    def _put(t: torch.Tensor) -> torch.Tensor:
        cast = dtype if dtype is not None and t.is_floating_point() else None
        return t.to(device=device, dtype=cast, copy=True)

    return {name: _put(t) for name, t in state.items()}
