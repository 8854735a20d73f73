"""Fixtures and helpers shared by the port's control-plane tests
(managed jobs, SkyServe, the dedicated controller).

The port's agents, the jobs they run, serve replicas and the controller
daemon are all detached processes.  `reap_marked` exports a marker of
its own for the life of a test module: every process spawned meanwhile
inherits it (each spawn path builds its env from os.environ), and at
the module's end every process still carrying it is SIGKILLed.
conftest.py's session reaper knows only the JAX agent's command line.
`port_home` is conftest's isolated $HOME with the port's config cache
reset and the local cloud as the one enabled cloud (the port registers
no other), and it stops the port's controller threads on the way out:
a controller outliving its test would poll under the next test's $HOME.
"""
import os
import signal
import sys
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


def cmdline_of(pid: int) -> str:
    with open(f'/proc/{pid}/cmdline', 'rb') as f:
        return f.read().replace(b'\0', b' ').decode()


__all__ = ['MARK_ENV', 'cmdline_of', 'kill_marked', 'kill_with_env',
           'port_home', 'reap_marked', 'stop_port_controllers']
