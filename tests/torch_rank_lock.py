"""One set of rank processes computing at a time, across test processes.

The port's rank-pool tests (`tests/test_torch_*.py` that spawn gloo
ranks) each start 2-8 CPU-bound processes.  Under pytest-xdist several
such files would run side by side and starve the JAX package's tests
that poll on wall-clock deadlines.  `hold()` is a cross-process `fcntl`
lock on a file under the system temp directory (released when its
holder exits, however it exits); the ranks also run at niceness +10
where their tests allow it.

A module's pools are `LockedPool`s: spawning them (each rank imports
torch and the test module) and every `run` take the lock, and nothing
else does.  Between runs the ranks block on their pipes and use no CPU,
so the parent's own work (a JAX reference, building inputs, checking
results) runs outside the lock and another file's ranks may run
meanwhile: the lock serializes rank compute, not whole modules.  (Two
holders at a time made the suite slower: the machine is CPU-bound
through the run, and more concurrent ranks only slowed everything
else.)

Every hold prints one stderr line, `[rank lock] <what> waited W s, held
H s` (pytest shows it with -s, -rA or on failure); summing H over a run
gives the serialized rank time, W the time rank files waited for it.
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
    """Hold the rank-pool lock for the body; prints how long it waited
    for the lock and how long it held it."""
    t0 = time.monotonic()
    with open(lock_path(), 'a+') as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        t1 = time.monotonic()
        try:
            yield t1 - t0
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
            print(f'[rank lock] {what or "a rank pool"} waited '
                  f'{t1 - t0:.1f} s, held {time.monotonic() - t1:.1f} s',
                  file=sys.stderr)


class LockedPool:
    """`world` gloo ranks on the CPU (a `parallel.group.RankPool`, one
    intra-op thread each, collectives bounded by `timeout_s`) spawned
    under the lock, whose `run` holds the lock for the call."""

    def __init__(self, what: str, world: int, timeout_s: float,
                 nice: int = 10):
        from skypilot_tpu_torch.parallel import group as group_lib
        self.what = what
        with hold(f'{what} (spawn)'):
            self.pool = group_lib.RankPool(world, 'gloo',
                                           timeout_s=timeout_s, threads=1)
            if nice:
                # A lower CPU priority (niceness +nice): the ranks share
                # the machine with tests that poll on deadlines.
                self.pool.run(os.nice, nice, timeout_s=timeout_s)

    def run(self, fn, *args, **kwargs):
        with hold(self.what):
            return self.pool.run(fn, *args, **kwargs)

    def close(self) -> None:
        self.pool.close()

