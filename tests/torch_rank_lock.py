"""One spawner of rank processes at a time, across test processes.

The port's rank-pool tests (`tests/test_torch_*.py` that spawn gloo
ranks) each start 2-8 CPU-bound processes.  Under pytest-xdist several
such files would run side by side and starve the JAX package's tests
that poll on wall-clock deadlines.  `hold()` is a cross-process `fcntl`
lock on a file under the system temp directory: a module fixture takes
it for the life of its pools, so at most one file spawns ranks at any
moment and the others wait (the lock is released when its holder exits,
however it exits).
"""
import contextlib
import fcntl
import os
import sys
import tempfile
import time

LOCK_NAME = 'skytpu_torch_rank_pools.lock'


def lock_path() -> str:
    return os.path.join(tempfile.gettempdir(), LOCK_NAME)


@contextlib.contextmanager
def hold(what: str = ''):
    """Hold the rank-pool lock for the body; a wait over 1 s goes to
    stderr (pytest shows it with -s, -rA or on failure)."""
    t0 = time.monotonic()
    with open(lock_path(), 'a+') as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        waited = time.monotonic() - t0
        if waited > 1.0:
            print(f'[rank lock] {what or "a rank pool"} waited '
                  f'{waited:.1f} s', file=sys.stderr)
        try:
            yield waited
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
