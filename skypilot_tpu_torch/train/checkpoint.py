"""Training checkpoints: the preemption-recovery path.

The API of `skypilot_tpu/train/checkpoint.py::CheckpointManager`
(`latest_step`, `save(step, state)`, `restore(step, target)`, `close`,
`max_to_keep=3`), without orbax.  Each step is a directory `step_<n>/`,
written under a temporary name and renamed, so a reader never sees a
half-written step.  `state` is the trainer's `TrainState` (or, unsharded,
any object with `state_dict()`/`load_state_dict()`).

- One device: `step_<n>/state.pt`, `torch.save` of `state_dict()`, loaded
  back with `torch.load(weights_only=True)` onto the target's device.
- Sharded over a mesh (`state.layout` set): `torch.distributed.checkpoint`
  (DCP), every rank writing its shards into `step_<n>/`.  Parameters and
  AdamW moments are saved as whole tensors (`ShardedLayout.global_view`:
  each rank's FSDP shard of its tensor slice placed in the whole), so a
  step restores onto another plan, or onto one device, as orbax
  reshards on load; the AdamW step counts, the step, the schedule's state
  and the learning rate go with them.

`read_params` gives the parameters of either format, whole or a block of
each (the serving loader reads a step trained under a mesh through it,
a tensor-parallel rank only its slices).
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

_STEP_DIR = re.compile(r'step_(\d+)')
_STATE_FILE = 'state.pt'
_DCP_FILE = '.metadata'
_PARAMS = 'params.'


# (name, whole shape) -> (offsets, sizes) of the block to read.
Box = Callable[[str, Tuple[int, ...]], Tuple[Tuple[int, ...],
                                             Tuple[int, ...]]]


def _block_planner(offsets: Dict[str, Tuple[int, ...]]):
    """A DCP load planner that fills each target tensor with the block of
    its whole tensor starting at `offsets[key]` (the target's size), reading
    only the saved chunks that overlap it."""
    from torch.distributed.checkpoint import DefaultLoadPlanner
    from torch.distributed.checkpoint.metadata import ChunkStorageMetadata
    from torch.distributed.checkpoint.planner import LoadPlan
    from torch.distributed.checkpoint.planner_helpers import (
        create_read_items_for_chunk_list)

    class BlockPlanner(DefaultLoadPlanner):

        def create_local_plan(self) -> LoadPlan:
            items = []
            for key, t in self.state_dict.items():
                items += create_read_items_for_chunk_list(
                    key, self.metadata.state_dict_metadata[key],
                    [ChunkStorageMetadata(offsets=torch.Size(offsets[key]),
                                          sizes=t.shape)])
            return LoadPlan(items)

        def lookup_tensor(self, index):
            # The target is the block itself (the default lookup wants a
            # plain tensor at offset 0).
            return self.state_dict[index.fqn]

    return BlockPlanner()


def _adam_state(optimizer: torch.optim.Optimizer, p) -> Dict[str, Any]:
    """p's AdamW state, made as the optimizer's first step makes it when
    p has none yet (zero moments, step 0 on the host)."""
    state = optimizer.state[p]
    if not state:
        state['step'] = torch.tensor(0.0)
        state['exp_avg'] = torch.zeros_like(p,
                                            memory_format=torch.preserve_format)
        state['exp_avg_sq'] = torch.zeros_like(
            p, memory_format=torch.preserve_format)
    return state


def dcp_items(state) -> Dict[str, Any]:
    """The flat dict a DCP step holds, over `state`'s own storage (DCP
    writes a restore into it in place): whole tensors on one device,
    `global_view`s of the shards under a mesh."""
    layout = state.layout
    items: Dict[str, Any] = {}
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            adam = _adam_state(state.optimizer, p)

            def view(t, name=name):
                return (t.detach() if layout is None
                        else layout.global_view(t, name))

            items[_PARAMS + name] = view(p)
            items[f'optimizer.{name}.exp_avg'] = view(adam['exp_avg'])
            items[f'optimizer.{name}.exp_avg_sq'] = view(adam['exp_avg_sq'])
            items[f'optimizer.{name}.step'] = adam['step']
    items['step'] = state.step
    items['schedule'] = state.schedule.state_dict()
    items['lr'] = [group['lr'] for group in state.optimizer.param_groups]
    return items


class CheckpointManager:

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f'step_{step}')

    def state_path(self, step: int) -> str:
        """The file holding step `step`'s state (one-device format)."""
        return os.path.join(self._path(step), _STATE_FILE)

    def is_sharded(self, step: int) -> bool:
        """True when step `step` was saved by DCP (under a mesh)."""
        return os.path.exists(os.path.join(self._path(step), _DCP_FILE))

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.fullmatch(name)
            if m and any(os.path.exists(os.path.join(self.directory, name, f))
                         for f in (_STATE_FILE, _DCP_FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _prune(self) -> None:
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old))

    def save(self, step: int, state: Any) -> None:
        """Write `state` as step `step` (synchronously), then drop the
        oldest steps beyond `max_to_keep`.  A sharded state is saved by
        every rank of its mesh together."""
        if getattr(state, 'layout', None) is not None:
            self._save_sharded(step, state)
            return
        tmp = tempfile.mkdtemp(prefix=f'.step_{step}-', dir=self.directory)
        try:
            torch.save(state.state_dict(), os.path.join(tmp, _STATE_FILE))
            final = self._path(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
        self._prune()

    def _save_sharded(self, step: int, state: Any) -> None:
        import torch.distributed.checkpoint as dcp
        tmp = os.path.join(self.directory, f'.step_{step}.dcp')
        lead = dist.get_rank() == 0
        if lead and os.path.exists(tmp):
            shutil.rmtree(tmp)
        dist.barrier()
        dcp.save(dcp_items(state), checkpoint_id=tmp)
        dist.barrier()
        if lead:
            final = self._path(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._prune()
        dist.barrier()

    def restore(self, step: int, target: Any) -> Any:
        """Load step `step` into `target` and return it.  A DCP step
        restores onto any plan (every rank of the target's mesh together)
        or onto one device; a `state.pt` step onto one device."""
        sharded_target = getattr(target, 'layout', None) is not None
        if not self.is_sharded(step):
            if sharded_target:
                raise ValueError(f'step {step} is a one-device state.pt: '
                                 f'restore it on one device')
            state = torch.load(self.state_path(step),
                               map_location=target.device, weights_only=True)
            target.load_state_dict(state)
            return target
        import torch.distributed.checkpoint as dcp
        items = dcp_items(target)
        dcp.load(items, checkpoint_id=self._path(step),
                 no_dist=not sharded_target)
        # Every param group follows the one schedule: a step saved with
        # another number of groups (a MoE mesh keeps its experts in a
        # group of their own) restores group 0's values into each.
        n = len(target.optimizer.param_groups)
        target.schedule.load_state_dict({
            k: [v[0]] * n if isinstance(v, list) and len(v) != n else v
            for k, v in items['schedule'].items()})
        for group in target.optimizer.param_groups:
            group['lr'] = items['lr'][0]
        return target

    def read_params(self, step: int, box: Optional[Box] = None
                    ) -> Dict[str, torch.Tensor]:
        """The parameters of step `step` on the host, by name (the state
        dict `Llama(cfg, params)` takes), whichever format.  With `box`
        (name, whole shape -> (offsets, sizes)) each is only that block
        of the whole (a tensor-parallel rank's slice).  A `state.pt` is
        memory-mapped (the blocks are views of it); from a DCP step only
        the blocks' bytes are read, into tensors of their size."""
        if not self.is_sharded(step):
            state = torch.load(self.state_path(step), map_location='cpu',
                               weights_only=True, mmap=True)
            if isinstance(state, dict) and isinstance(state.get('params'),
                                                      dict):
                state = state['params']
            if box is None:
                return state
            out = {}
            for name, t in state.items():
                for dim, (start, size) in enumerate(zip(*box(name,
                                                             t.shape))):
                    t = t.narrow(dim, start, size)
                out[name] = t
            return out
        import torch.distributed.checkpoint as dcp
        reader = dcp.FileSystemReader(self._path(step))
        meta = reader.read_metadata().state_dict_metadata
        params, offsets = {}, {}
        for key, m in meta.items():
            if not key.startswith(_PARAMS):
                continue
            start, size = ((0,) * len(m.size), tuple(m.size)) if box is None \
                else box(key[len(_PARAMS):], tuple(m.size))
            params[key] = torch.empty(size, dtype=m.properties.dtype)
            offsets[key] = start
        dcp.load(params, storage_reader=reader, no_dist=True,
                 planner=_block_planner(offsets))
        return {key[len(_PARAMS):]: t for key, t in params.items()}

    def close(self) -> None:
        """Saves are synchronous: nothing is in flight."""
