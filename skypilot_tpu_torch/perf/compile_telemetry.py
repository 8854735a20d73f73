"""Build telemetry + the runtime recompile sentinel (PyTorch).

Twin of `skypilot_tpu/perf/compile_telemetry.py`.  The port compiles
nothing through XLA; its counterparts of "a compile" are the two places
where it builds a device program before it can run:

- the kernel library's build (`ops/cuda/flash_attention.py`, when it runs
  `nvcc`; a library already on disk is loaded, not built);
- each decode or speculative-verify call object (`inference/engine.py`
  `_DecodeCall` / `_VerifyCall`): on the card the capture of its CUDA
  graph, on the CPU its construction (nothing is captured there, so the
  sentinel's contract is testable without a card, as the JAX package's
  is with CPU jit compiles).

Both sites wrap the build in `compiling(kind, shapes)`, which times it,
increments `skytpu_engine_xla_compile_total` and observes
`skytpu_engine_xla_compile_seconds` (the JAX package's metric names,
kept so dashboards read one family; in the port they count these
builds).  `summary()` keeps the count and seconds per kind.

The SENTINEL: once `arm()` is called (the engine arms it when
`prewarm()` has built the kernels and captured every call it will use),
every further build is a mid-traffic stall by definition.  Each one
records a flight-recorder instant event (`perf.recompile`, rid
`recompile-sentinel`) carrying the shape string (call kind, output rows
[T+1, n_slots], draft length k, paged or not, KV dtype).
`SKYTPU_STRICT_RECOMPILE=1` escalates to a hard RuntimeError raised
INSIDE the building call, before anything is built or captured, so the
failure lands on the code path that built late and no graph capture is
left half open.  A build inside `warmup()` (prewarm) is never a hazard,
so one engine's prewarm does not trip the sentinel another armed.

Arming is a plain process-global flag, as in JAX: `disarm()` /
`reset_for_tests()` return the process to record-only mode.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator

from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing

# Flight-recorder request id the sentinel events land under: a fixed,
# grep-able id so `/debug/requests` surfaces every post-warmup build in
# one place.
SENTINEL_REQUEST_ID = 'recompile-sentinel'
STRICT_ENV = 'SKYTPU_STRICT_RECOMPILE'

_LOCK = threading.Lock()
_STATE = {'armed': False}
# kind -> [builds, seconds] since the process started (or the last
# reset_for_tests()).
_TOTALS: Dict[str, list] = {}
_WARMUP = threading.local()


def _hazard(kind: str, shapes: str, seconds: float) -> None:
    tracing.record_instant(SENTINEL_REQUEST_ID, 'perf.recompile',
                           compile_seconds=round(seconds, 4),
                           kind=kind, shapes=shapes)


@contextlib.contextmanager
def warmup() -> Iterator[None]:
    """Builds on this thread inside the block are warmup (prewarm), not
    hazards, even while the sentinel is armed."""
    prev = getattr(_WARMUP, 'on', False)
    _WARMUP.on = True
    try:
        yield
    finally:
        _WARMUP.on = prev


@contextlib.contextmanager
def compiling(kind: str, shapes: str) -> Iterator[None]:
    """Wrap one device-program build (`kind`: 'kernel_build', 'decode',
    'verify'; `shapes`: what is built).  Armed and outside `warmup()`,
    the build is a post-warmup hazard: under SKYTPU_STRICT_RECOMPILE=1
    it is recorded and refused before the body runs; otherwise recorded
    after it, with its seconds."""
    hazard = _STATE['armed'] and not getattr(_WARMUP, 'on', False)
    if hazard and os.environ.get(STRICT_ENV, '') == '1':
        _hazard(kind, shapes, 0.0)
        raise RuntimeError(
            f'post-warmup {kind} build (shapes: {shapes}): the engine was '
            f'prewarmed, so this build stalls live traffic. Build it in '
            f'prewarm() or unset {STRICT_ENV} to record-only mode.')
    t0 = time.perf_counter()
    yield
    seconds = time.perf_counter() - t0
    metrics_lib.inc_counter('skytpu_engine_xla_compile_total')
    metrics_lib.observe_hist('skytpu_engine_xla_compile_seconds', seconds)
    with _LOCK:
        tally = _TOTALS.setdefault(kind, [0, 0.0])
        tally[0] += 1
        tally[1] += seconds
    if hazard:
        _hazard(kind, shapes, seconds)


def summary() -> Dict[str, tuple]:
    """{kind: (builds, seconds)} counted by `compiling()` so far."""
    with _LOCK:
        return {kind: (n, s) for kind, (n, s) in _TOTALS.items()}


def install() -> None:
    """The JAX module's process-wide hook registration, kept for its
    callers: the JAX module registers a jax.monitoring listener here,
    while the port's build sites call `compiling()` themselves, so there
    is nothing to register and this does nothing."""


def arm() -> None:
    """Declare warmup complete: builds from here on are hazards."""
    _STATE['armed'] = True


def disarm() -> None:
    _STATE['armed'] = False


def armed() -> bool:
    return _STATE['armed']


def reset_for_tests() -> None:
    _STATE['armed'] = False
    with _LOCK:
        _TOTALS.clear()
