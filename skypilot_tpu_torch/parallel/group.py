"""The process group of one serve replica (or one test) over several
devices: PyTorch's idiom has no single controller, so a mesh is one
process per rank, joined in one `torch.distributed` group.

- `Followers`: this process becomes rank 0 and ranks 1..N-1 are spawned
  (start method 'spawn') running `target(*args)`; the server uses it
  for `--tensor N`.  Rank 0 takes every request and leads, the followers
  run the engine's `follow()`.
- `RankPool`: all N ranks spawned, each running the functions given to
  `run` and returning its result; tests and `chip_smoke.py` run one
  function on every rank with it and read rank 0's result (every
  rank's, to compare them).
- `Control`: rank 0's broadcast to the followers over the mesh's gloo
  control group (CPU tensors): a fixed-shape int64 header, then int64
  payloads and raw tensors whose sizes the header announces.

Every rank joins at `tcp://127.0.0.1:<free port>` with the group's
world size and its rank (nothing on the machine names a cluster).
Every wait is bounded: a collective fails after `timeout_s`, a pool
call after its own timeout, and closing joins each process with a
timeout and kills what is left.
"""
from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import pickle
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from skypilot_tpu_torch import sky_logging

logger = sky_logging.init_logger(__name__)

DEFAULT_TIMEOUT_S = 600.0


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def join(rank: int, world: int, port: int, backend: str,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to the group as `rank` of `world`; returns once
    every rank has joined."""
    dist.init_process_group(
        backend, init_method=f'tcp://127.0.0.1:{port}', world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def leave() -> None:
    """Leave this process's group (and forget the meshes built on it)."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    mesh_lib.forget_meshes()
    if dist.is_initialized():
        dist.destroy_process_group()


def stop_processes(procs, timeout_s: float) -> None:
    """Join each process within `timeout_s`, then kill what is left."""
    for proc in procs:
        proc.join(timeout_s)
    for proc in procs:
        if proc.is_alive():
            logger.warning(f'rank process {proc.pid} still alive after '
                           f'{timeout_s} s: killed')
            proc.kill()
            proc.join(5)


def _follower_entry(rank, world, port, backend, timeout_s, target, args):
    join(rank, world, port, backend, timeout_s)
    try:
        target(*args)
    finally:
        leave()


class Followers:
    """Ranks 1..world-1 of a group whose rank 0 is the calling process.
    Construction spawns them, joins this process as rank 0 and returns
    once every rank has joined."""

    def __init__(self, world: int, backend: str, target: Callable,
                 args: Sequence[Any] = (),
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        port = free_port()
        ctx = multiprocessing.get_context('spawn')
        self.procs = [ctx.Process(
            target=_follower_entry, daemon=True,
            args=(rank, world, port, backend, timeout_s, target,
                  tuple(args)),
            name=f'rank-{rank}') for rank in range(1, world)]
        for proc in self.procs:
            proc.start()
        try:
            join(0, world, port, backend, timeout_s)
        except BaseException:
            self.close(0.0)
            raise

    def close(self, timeout_s: float = 30.0) -> None:
        """Wait for the followers to return (after the leader told them
        to stop), kill any left after `timeout_s`, leave the group."""
        stop_processes(self.procs, timeout_s)
        leave()


def _pool_entry(rank, world, port, backend, timeout_s, threads, conn):
    if threads:
        torch.set_num_threads(threads)
    join(rank, world, port, backend, timeout_s)
    try:
        while True:
            job = conn.recv_bytes()
            if not job:
                return
            fn, args = pickle.loads(job)
            try:
                reply = (True, fn(*args))
            except BaseException:  # pylint: disable=broad-except
                reply = (False, traceback.format_exc())
            conn.send_bytes(pickle.dumps(reply))
    finally:
        leave()


class RankPool:
    """`world` spawned ranks in one group of `backend`, alive until
    `close()`: `run(fn, *args)` calls fn(*args) in every rank (fn must be
    importable by name, e.g. a module-level function) and returns the
    results in rank order.  A failed or timed-out call closes the pool.
    `threads` caps each rank's intra-op CPU threads.  Jobs and results
    travel pickled by value over one pipe per rank."""

    ERROR_GRACE_S = 10.0

    def __init__(self, world: int, backend: str = 'gloo',
                 timeout_s: float = 120.0,
                 threads: Optional[int] = None) -> None:
        self.world = world
        port = free_port()
        ctx = multiprocessing.get_context('spawn')
        pipes = [ctx.Pipe() for _ in range(world)]
        self._conns = [mine for mine, _ in pipes]
        self.procs = [ctx.Process(
            target=_pool_entry, daemon=True,
            args=(rank, world, port, backend, timeout_s, threads,
                  pipes[rank][1]), name=f'pool-rank-{rank}')
            for rank in range(world)]
        for proc in self.procs:
            proc.start()
        for _, theirs in pipes:
            theirs.close()
        self.closed = False

    def run(self, fn: Callable, *args, timeout_s: float = 300.0) -> List:
        if self.closed:
            raise RuntimeError('the rank pool is closed (an earlier call '
                               'failed or timed out)')
        job = pickle.dumps((fn, args))
        for conn in self._conns:
            conn.send_bytes(job)
        results, errors = {}, []
        deadline = time.monotonic() + timeout_s
        while len(results) < self.world:
            pending = [c for r, c in enumerate(self._conns)
                       if r not in results]
            ready = multiprocessing.connection.wait(
                pending, max(deadline - time.monotonic(), 0.0))
            if not ready:
                self.close(0.0)
                missing = sorted(set(range(self.world)) - set(results))
                raise TimeoutError(
                    f'{fn.__name__} did not return on ranks {missing} '
                    f'within {timeout_s} s' +
                    ''.join(f'\n{e}' for e in errors))
            for conn in ready:
                rank = self._conns.index(conn)
                try:
                    ok, value = pickle.loads(conn.recv_bytes())
                except EOFError:
                    ok, value = False, 'the rank process exited'
                results[rank] = value if ok else None
                if not ok:
                    errors.append(f'rank {rank}:\n{value}')
                    # The others are likely blocked in a collective with
                    # the failed rank: give them a short grace, not the
                    # whole timeout.
                    deadline = min(deadline,
                                   time.monotonic() + self.ERROR_GRACE_S)
        if errors:
            self.close(5.0)
            raise RuntimeError(f'{fn.__name__} failed:\n' +
                               '\n'.join(errors))
        return [results[rank] for rank in range(self.world)]

    def close(self, timeout_s: float = 30.0) -> None:
        if not self.closed:
            self.closed = True
            for conn in self._conns:
                try:
                    conn.send_bytes(b'')
                except OSError:
                    pass
        stop_processes(self.procs, timeout_s)
        for conn in self._conns:
            conn.close()

    def __enter__(self) -> 'RankPool':
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Control:
    """Rank 0's broadcasts to the other ranks of `mesh` over its gloo
    control group (CPU tensors).  The leader calls the `send_*` methods
    and the followers the matching `recv_*` ones, in the same order."""

    HEADER = 8

    def __init__(self, mesh) -> None:
        self.group = mesh.control_group
        self.leader = mesh.rank == 0

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=0, group=self.group)
        return t

    def send_header(self, values: Sequence[int]) -> None:
        header = np.zeros((self.HEADER,), np.int64)
        header[:len(values)] = values
        self._bcast(torch.from_numpy(header))

    def recv_header(self) -> np.ndarray:
        return self._bcast(torch.zeros((self.HEADER,),
                                       dtype=torch.int64)).numpy()

    def send_ints(self, values: np.ndarray) -> None:
        self._bcast(torch.from_numpy(np.ascontiguousarray(values,
                                                          np.int64)))

    def recv_ints(self, n: int) -> np.ndarray:
        return self._bcast(torch.zeros((n,), dtype=torch.int64)).numpy()

    def send_tensor(self, t: torch.Tensor) -> None:
        """Any dtype, as its bytes (a CPU tensor)."""
        self._bcast(t.contiguous().view(torch.uint8))

    def recv_tensor(self, shape, dtype: torch.dtype) -> torch.Tensor:
        t = torch.empty(tuple(shape), dtype=dtype)
        self._bcast(t.view(torch.uint8))
        return t
