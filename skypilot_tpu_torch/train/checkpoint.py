"""Training checkpoints with `torch.save`: the preemption-recovery path.

The API of `skypilot_tpu/train/checkpoint.py::CheckpointManager`
(`latest_step`, `save(step, state)`, `restore(step, target)`, `close`,
`max_to_keep=3`), without orbax: each step is a directory `step_<n>/`
holding `state.pt`, written under a temporary name and renamed, so a
reader never sees a half-written step.  `state` is any object with
`state_dict()`/`load_state_dict()` (the trainer's `TrainState`); it is
loaded back with `torch.load(weights_only=True)` onto the target's
device.
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Any, List, Optional

import torch

_STEP_DIR = re.compile(r'step_(\d+)')
_STATE_FILE = 'state.pt'


class CheckpointManager:

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f'step_{step}')

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.fullmatch(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 _STATE_FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Write `state.state_dict()` as step `step` (synchronously), then
        drop the oldest steps beyond `max_to_keep`."""
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
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old))

    def restore(self, step: int, target: Any) -> Any:
        """Load step `step` into `target` (its `load_state_dict`) and
        return it."""
        state = torch.load(os.path.join(self._path(step), _STATE_FILE),
                           map_location=target.device, weights_only=True)
        target.load_state_dict(state)
        return target

    def close(self) -> None:
        """Saves are synchronous: nothing is in flight."""
