"""Checkpoint loading for serve replicas (PyTorch).

Twin of `skypilot_tpu/inference/weights.py::load_serving_params`: a
training run checkpoints through `train/checkpoint.py` (`step_<n>/
state.pt`, written by `torch.save`), and the serve replica restores the
params at startup.  Train and serve share one state dict (the names
`Llama(cfg, params)` loads), so no conversion step is needed.

A tensor-parallel replica passes its `mesh` (`parallel/mesh.py`): each
rank reads only its slices of the memory-mapped file, or of a step saved
under a training mesh (`serving_shardings` names them, the counterpart
of the JAX function of that name) and copies them to its device, so the
whole tree never sits on one device or on one host.

Not here yet: `gs://` paths (the JAX package fetches them through its
storage layer, which the port has no copy of).  A JAX trainer's orbax
checkpoint is not read: carry JAX weights across in memory with
`models/convert.py::params_from_jax` (and `shard_params` on a mesh).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.device import DeviceLike, resolve_device
from skypilot_tpu_torch.train.checkpoint import CheckpointManager

logger = sky_logging.init_logger(__name__)


def serving_shardings(cfg, mesh) -> Dict[str, tuple]:
    """{param name: PartitionSpec} of a `Llama(cfg, ...)` on a serve
    mesh: the parameter table's logical axes through the default rules
    (heads, MLP hidden and vocab over `tensor`), every dim the mesh does
    not divide kept whole."""
    from skypilot_tpu_torch.models.llama import param_shapes
    from skypilot_tpu_torch.parallel import sharding
    return {name: sharding.param_spec(name, shape, mesh.shape)
            for name, shape in param_shapes(cfg).items()}


def load_serving_params(path: str, step: Optional[int] = None,
                        dtype: Optional[torch.dtype] = None,
                        device: DeviceLike = None,
                        mesh: Any = None
                        ) -> Dict[str, torch.Tensor]:
    """The params of checkpoint step `step` (None: the latest) under
    `path`, as the state dict `Llama(cfg, params)` takes, on `device`
    (default: the GPU; raises without one).

    Accepts a full `TrainState` checkpoint (`{'params', 'optimizer',
    'schedule', 'step'}`, train/trainer.py; everything but `params` is
    dropped), a params-only state dict, or a step a trainer saved under a
    mesh (DCP; the optimizer's moments are not read at all).  `dtype` casts the floating tensors only.  A `state.pt`
    is read with `weights_only=True` and memory-mapped, so a TrainState's
    optimizer moments are never read; each param is copied to `device`
    (and cast) one tensor at a time.  Under a `mesh` (default device:
    the mesh's) only this rank's slice of each param is read and copied.
    """
    if path.startswith('gs://'):
        raise ValueError(
            f'{path!r}: gs:// checkpoints come with the storage slice of '
            f'the port (the bucket fetch is not ported); copy the '
            f'checkpoint to a local directory first')
    if device is None and mesh is not None:
        device = mesh.device
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
    box = None
    if mesh is not None:
        from skypilot_tpu_torch.parallel import sharding

        def box(name, shape):
            return sharding.local_box(
                shape, sharding.param_spec(name, shape, mesh.shape), mesh)
    state = mgr.read_params(step, box)

    def _put(name: str, t: torch.Tensor) -> torch.Tensor:
        cast = dtype if dtype is not None and t.is_floating_point() else None
        return t.to(device=device, dtype=cast, copy=True).contiguous()

    return {name: _put(name, t) for name, t in state.items()}
