"""Standalone managed-jobs controller daemon — the dedicated-controller
("controller on VM") runtime.

In consolidation mode controller threads live inside the API server
process; in dedicated mode this daemon runs ON the controller cluster
(a CPU VM launched through the normal stack — parity:
sky/jobs/server/core.py:494,:527 launching jobs-controller.yaml.j2), so
controller load and blast radius are decoupled from the API server: the
server can die and restart while jobs keep recovering.

Single instance per $HOME, enforced with a pid file: the daemon re-adopts
unfinished jobs on start (maybe_start_controllers scans the state DB) and
keeps polling for newly submitted ones.

Usage: python -m skypilot_tpu_torch.jobs.controller_daemon
"""
from __future__ import annotations

import os
import sys
import time


def pid_file_path() -> str:
    return os.path.expanduser('~/.skytpu/jobs-controller-daemon.pid')


def daemon_alive() -> bool:
    """True iff a live daemon owns the pid file."""
    try:
        with open(pid_file_path(), encoding='utf-8') as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return False
    try:
        with open(f'/proc/{pid}/cmdline', 'rb') as f:
            return b'controller_daemon' in f.read()
    except OSError:
        return False


def main() -> int:
    if daemon_alive():
        print('daemon already running', flush=True)
        return 0
    path = pid_file_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w', encoding='utf-8') as f:
        f.write(str(os.getpid()))
    from skypilot_tpu_torch import sky_logging
    from skypilot_tpu_torch.jobs import controller as controller_lib
    from skypilot_tpu_torch.serve import controller as serve_controller_lib
    logger = sky_logging.init_logger(__name__)
    logger.info('controller daemon up (pid %d)', os.getpid())
    poll = float(os.environ.get('SKYTPU_JOBS_POLL_INTERVAL', '10'))
    while True:
        # Both controller kinds: a host dedicated to one namespace just
        # finds the other's state DB empty.
        try:
            controller_lib.maybe_start_controllers()
        except Exception as e:  # pylint: disable=broad-except
            logger.error('jobs controller tick failed: %s', e)
        try:
            serve_controller_lib.maybe_start_controllers()
        except Exception as e:  # pylint: disable=broad-except
            logger.error('serve controller tick failed: %s', e)
        time.sleep(max(poll, 0.2))


if __name__ == '__main__':
    sys.exit(main())
