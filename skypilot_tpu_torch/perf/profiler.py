"""On-demand torch.profiler capture with bounded on-disk retention.

Twin of `skypilot_tpu/perf/profiler.py`.  Backs the inference server's
`GET /debug/profile?duration_ms=` route: start `torch.profiler` (CPU
activity, plus CUDA activity when a card is present), hold the window
open, stop, and hand back a Perfetto-loadable chrome trace, gzipped as
`perfetto_trace.json.gz` inside the capture directory, living under a
retention-bounded directory.  Long-lived replicas must not grow disk
without bound, so the store keeps the newest `SKYTPU_PROFILE_RETAIN`
captures (default 4), prunes the rest after every capture, and
`cleanup()` (wired to the server's shutdown) removes everything the
store created (including its own tmpdir when no SKYTPU_PROFILE_DIR was
given).

The profiler is process-global: the capture runs on an executor thread
while the engine's loop thread launches the kernels, so it records the
operators of every thread (`profile_all_threads`), and CUDA activity is
traced for the whole device (graph replays included).  Captures are
serialized behind `TRACE_LOCK`, taken without blocking: a second
concurrent request gets a CaptureBusy (the HTTP layer maps it to 409)
instead of corrupting the trace.  The engine's CUDA graph captures take
the same lock (blocking), so a profiler window and a graph capture never
overlap: tracing while a graph is being captured is not assumed safe.
"""
from __future__ import annotations

import gzip
import os
import pathlib
import shutil
import threading
import time
from typing import List, Optional

import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing

RETAIN_ENV = 'SKYTPU_PROFILE_RETAIN'
DIR_ENV = 'SKYTPU_PROFILE_DIR'
# Upper bound on one capture window: /debug/profile is a debugging
# endpoint, not a long-running recorder.
MAX_CAPTURE_MS = 60_000.0
# Held by a profiler window (non-blocking) and by a CUDA graph capture
# (blocking): one process-wide profiler, and no tracing mid-capture.
TRACE_LOCK = threading.Lock()


class CaptureBusy(RuntimeError):
    """A capture (or a CUDA graph capture) holds the process-global
    profiler."""


class ProfileStore:
    """Retention-bounded home for /debug/profile artifacts."""

    def __init__(self, root: Optional[str] = None,
                 retain: Optional[int] = None) -> None:
        env_root = root or os.environ.get(DIR_ENV)
        # Created-by-us tmpdirs are removed wholesale at cleanup();
        # a user-supplied dir only has our capture-* children removed.
        self._owns_root = env_root is None
        if env_root is None:
            import tempfile
            env_root = tempfile.mkdtemp(prefix='skytpu-profile-')
        self._root = pathlib.Path(env_root)
        self._root.mkdir(parents=True, exist_ok=True)
        self._retain = max(1, int(retain if retain is not None else
                                  os.environ.get(RETAIN_ENV, '4')))
        self._seq = 0

    @property
    def root(self) -> pathlib.Path:
        return self._root

    def captures(self) -> List[str]:
        """Capture dir names, oldest first (sortable sequence names)."""
        return sorted(p.name for p in self._root.glob('capture-*')
                      if p.is_dir())

    def capture(self, duration_ms: float,
                request_id: Optional[str] = None) -> dict:
        """Run one profiler window; returns the artifact summary.

        Runs on an executor thread (it sleeps for the window), never on
        the event loop or the engine loop.
        """
        duration_ms = min(float(duration_ms), MAX_CAPTURE_MS)
        if duration_ms <= 0:
            raise ValueError(f'duration_ms must be positive, '
                             f'got {duration_ms}')
        if not TRACE_LOCK.acquire(blocking=False):
            raise CaptureBusy('a profiler capture or a CUDA graph capture '
                              'is in progress (torch.profiler is '
                              'process-global)')
        try:
            self._seq += 1
            name = f'capture-{self._seq:06d}'
            out = self._root / name
            out.mkdir(parents=True, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            t0 = time.perf_counter()
            # Every thread's operators, not only this executor thread's:
            # the engine's loop thread is the one that launches.
            with profile(activities=activities,
                         experimental_config=_ExperimentalConfig(
                             profile_all_threads=True)) as prof:
                time.sleep(duration_ms / 1e3)
            t1 = time.perf_counter()
            raw = out / 'trace.json'
            prof.export_chrome_trace(str(raw))
            artifact = out / 'perfetto_trace.json.gz'
            with open(raw, 'rb') as src, gzip.open(artifact, 'wb') as dst:
                shutil.copyfileobj(src, dst)
            raw.unlink()
            rel = str(artifact.relative_to(self._root))
            size = artifact.stat().st_size
            metrics_lib.inc_counter('skytpu_profile_captures_total')
            tracing.record_span(request_id, 'perf.profile_capture',
                                t0, t1, artifact=rel, size_bytes=size)
            self._prune()
            return {
                'name': name,
                'duration_ms': round((t1 - t0) * 1e3, 1),
                'artifact': rel,
                'size_bytes': size,
                'retained': self.captures(),
            }
        finally:
            TRACE_LOCK.release()

    def artifact_path(self, rel: str) -> pathlib.Path:
        """Resolve an artifact path, refusing traversal out of root."""
        path = (self._root / rel).resolve()
        if not str(path).startswith(str(self._root.resolve()) + os.sep):
            raise ValueError(f'artifact path escapes the profile dir: '
                             f'{rel!r}')
        if not path.is_file():
            raise FileNotFoundError(rel)
        return path

    def _prune(self) -> None:
        names = self.captures()
        for name in names[:-self._retain]:
            shutil.rmtree(self._root / name, ignore_errors=True)

    def cleanup(self) -> None:
        """Shutdown hook: leave NOTHING behind on long-lived hosts."""
        if self._owns_root:
            shutil.rmtree(self._root, ignore_errors=True)
            return
        for name in self.captures():
            shutil.rmtree(self._root / name, ignore_errors=True)
