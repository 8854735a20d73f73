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

A `gs://bucket/prefix` path is synced down to a temp directory first
(`data/storage.py`'s `GcsStore`: gsutil, or the fake-GCS root under
tests), loaded, and the temp directory removed after the load, whether
it succeeded or not (`_materialize_local` / `_cleanup_fetched`, the JAX
package's, pinned by tests/test_torch_package.py).  A JAX trainer's
orbax checkpoint is not read: carry JAX weights across in memory with
`models/convert.py::params_from_jax` (and `shard_params` on a mesh).
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

import torch

from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.device import DeviceLike, resolve_device
from skypilot_tpu_torch.train.checkpoint import CheckpointManager

logger = sky_logging.init_logger(__name__)


def _materialize_local(path: str) -> str:
    """Return a local directory holding the checkpoint.

    `gs://bucket/prefix` paths are synced down to a temp dir first
    (gsutil, or the fake-GCS root under tests — data/storage.py).
    Local paths are returned as-is.
    """
    if path.startswith('gs://'):
        from skypilot_tpu_torch.data import storage as storage_lib
        rest = path[len('gs://'):]
        bucket, _, prefix = rest.partition('/')
        local = tempfile.mkdtemp(prefix='skytpu-ckpt-')
        logger.info(f'fetching checkpoint {path} -> {local}')
        storage_lib.GcsStore(bucket).sync_down(local, prefix)
        return local
    return os.path.abspath(os.path.expanduser(path))


def _cleanup_fetched(path: str, local: str) -> None:
    """Remove the temp download for gs:// restores (a crash-looping
    replica must not fill /tmp with multi-GB checkpoint copies)."""
    if local != os.path.abspath(os.path.expanduser(path)):
        import shutil
        shutil.rmtree(local, ignore_errors=True)


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
    if device is None and mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    local = _materialize_local(path)
    try:
        if not os.path.isdir(local):
            raise FileNotFoundError(f'no checkpoint directory {path!r} '
                                    f'(resolved to {local!r})')
        mgr = CheckpointManager(local)
        if step is None:
            step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(
                f'no checkpoint steps found under {path!r} '
                f'(resolved to {local!r})')
        logger.info(f'restoring checkpoint step {step} from {path}')
        box = None
        if mesh is not None:
            from skypilot_tpu_torch.parallel import sharding

            def box(name, shape):
                return sharding.local_box(
                    shape, sharding.param_spec(name, shape, mesh.shape),
                    mesh)
        state = mgr.read_params(step, box)

        def _put(name: str, t: torch.Tensor) -> torch.Tensor:
            cast = (dtype if dtype is not None and t.is_floating_point()
                    else None)
            return t.to(device=device, dtype=cast, copy=True).contiguous()

        # Every tensor is copied off the (memory-mapped) file before a
        # fetched directory is removed.
        return {name: _put(name, t) for name, t in state.items()}
    finally:
        _cleanup_fetched(path, local)
