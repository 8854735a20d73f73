"""Fixtures and helpers shared by the port's control-plane tests
(managed jobs, SkyServe, the dedicated controller).

The port's agents, the jobs they run, serve replicas and the controller
daemon are all detached processes.  `reap_marked` exports a marker of
its own for the life of a test module: every process spawned meanwhile
inherits it (each spawn path builds its env from os.environ), and at
the module's end every process still carrying it is SIGKILLed.
conftest.py's session reaper knows only the JAX agent's command line.
`port_home` is conftest's isolated $HOME with the port's config cache
reset and the local cloud as the one enabled cloud (the cases launch
there), and it stops the port's controller threads on the way out:
a controller outliving its test would poll under the next test's $HOME.
`app_in_thread` serves an aiohttp app (either package's API server) on a
free port from a daemon thread, and `wait_for` is the bounded poll every
wait of these tests goes through: a hang fails its case at a deadline and
does not eat the run's clock.
"""
import asyncio
import contextlib
import os
import signal
import sys
import threading
import time
import uuid

import pytest

MARK_ENV = 'SKYTPU_TORCH_CONTROL_MARK'


def kill_marked(value: str) -> int:
    """SIGKILL every other process whose environment (as of its exec)
    holds MARK_ENV=value; returns how many."""
    return kill_with_env(f'{MARK_ENV}={value}')


def kill_with_env(entry_text: str) -> int:
    """SIGKILL every other process whose environment (as of its exec)
    holds the entry `entry_text` (say 'HOME=/tmp/x'); returns how many."""
    needle = b'\0' + entry_text.encode() + b'\0'
    killed = 0
    for entry in os.listdir('/proc'):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f'/proc/{entry}/environ', 'rb') as f:
                if needle not in b'\0' + f.read():
                    continue
            os.kill(int(entry), signal.SIGKILL)
            killed += 1
        except (OSError, ProcessLookupError):
            continue
    return killed


@pytest.fixture(scope='module', autouse=True)
def reap_marked():
    value = uuid.uuid4().hex
    old = os.environ.get(MARK_ENV)
    os.environ[MARK_ENV] = value
    yield value
    if old is None:
        os.environ.pop(MARK_ENV, None)
    else:
        os.environ[MARK_ENV] = old
    kill_marked(value)


def stop_port_controllers() -> None:
    """Stop the port's jobs and serve controller threads (no status
    writes), where their modules were imported."""
    sc = sys.modules.get('skypilot_tpu_torch.serve.controller')
    jc = sys.modules.get('skypilot_tpu_torch.jobs.controller')
    if sc is not None:
        sc.stop_all_controllers()
    if jc is not None:
        jc.stop_all_controllers()


@pytest.fixture
def port_home(tmp_home, monkeypatch):
    from skypilot_tpu_torch import sky_config
    monkeypatch.setenv('SKYTPU_ENABLED_CLOUDS', 'local')
    sky_config.reset_cache_for_tests()
    yield tmp_home
    stop_port_controllers()
    sky_config.reset_cache_for_tests()


def wait_for(probe, timeout_s: float, what: str, interval_s: float = 0.2):
    """Call `probe()` until it returns a truthy value and return that;
    TimeoutError naming `what` after `timeout_s` seconds."""
    deadline = time.monotonic() + timeout_s
    while True:
        value = probe()
        if value:
            return value
        if time.monotonic() > deadline:
            raise TimeoutError(f'{what}: not within {timeout_s} s')
        time.sleep(interval_s)


def bounded(fn, *args, timeout: float = 60.0, **kwargs):
    """fn(*args, **kwargs) on a daemon thread; its value, or its error
    raised here, or TimeoutError when it has not returned within
    `timeout` seconds (the thread is left behind: kill what it
    started)."""
    box = {}

    def run():
        try:
            box['value'] = fn(*args, **kwargs)
        except BaseException as e:  # pylint: disable=broad-except
            box['error'] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout)
    if thread.is_alive():
        raise TimeoutError(f'{getattr(fn, "__name__", fn)} did not return '
                           f'in {timeout} s')
    if 'error' in box:
        raise box['error']
    return box.get('value')


@contextlib.contextmanager
def app_in_thread(make_app, start_timeout_s: float = 60.0):
    """Serve `make_app()` with aiohttp's TestServer on a free port from a
    daemon thread with its own event loop; yields the base URL and closes
    the server (within 30 s) on the way out."""
    from aiohttp.test_utils import TestServer
    loop = asyncio.new_event_loop()
    box = {}

    def run():
        asyncio.set_event_loop(loop)
        try:
            server = TestServer(make_app())
            loop.run_until_complete(server.start_server())
        except BaseException as e:  # pylint: disable=broad-except
            box['error'] = e
            return
        box['server'] = server
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    wait_for(lambda: 'server' in box or 'error' in box, start_timeout_s,
             'API server start', interval_s=0.05)
    if 'error' in box:
        raise box['error']
    try:
        yield f'http://127.0.0.1:{box["server"].port}'
    finally:
        asyncio.run_coroutine_threadsafe(
            box['server'].close(), loop).result(timeout=30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        executor = box['server'].app.get('executor')
        if executor is not None:
            join_executor(executor)


def join_executor(executor, timeout_s: float = 30.0) -> None:
    """Wait for a shut-down `server.executor.RequestExecutor`'s
    supervising threads: each reads its request's row once more after
    its worker exits, and a read left running would land under whatever
    $HOME the next test sets (racing that test's schema creation:
    sqlite's "duplicate column name")."""
    bounded(executor._long.shutdown, True,  # pylint: disable=protected-access
            timeout=timeout_s)


def cmdline_of(pid: int) -> str:
    with open(f'/proc/{pid}/cmdline', 'rb') as f:
        return f.read().replace(b'\0', b' ').decode()


__all__ = ['MARK_ENV', 'app_in_thread', 'bounded', 'cmdline_of',
           'kill_marked', 'kill_with_env', 'port_home', 'reap_marked',
           'stop_port_controllers', 'wait_for']
