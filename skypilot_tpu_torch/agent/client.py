"""Client for the head-host agent, with transparent SSH tunneling.

Parity: SkyletClient (cloud_vm_ray_backend.py:2641) + the SSH tunnel it
rides (:2392).  For local clusters the agent listens on localhost directly;
for TPU VMs the client opens `ssh -L` to the head host first.

Counterpart of `skypilot_tpu/agent/client.py`: the same client, but it
waits for the SSH tunnel's local port to accept a connection before its
first request (up to TUNNEL_TIMEOUT_S, raising HeadNodeUnreachableError
if the tunnel exits or never opens).  The JAX client sends its first
request as soon as it has started `ssh -N -L`, before the forward is
listening, so that request finds the port closed.
"""
from __future__ import annotations

import socket
import subprocess
import time
from typing import Any, Dict, List, Optional

import requests

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.utils import command_runner as runner_lib
from skypilot_tpu_torch.utils import common_utils

AGENT_PORT = 8790
# How long a new SSH tunnel may take to open its local port.
TUNNEL_TIMEOUT_S = 30.0


class AgentClient:
    def __init__(self, head_ip: str,
                 ssh_user: str = 'skytpu',
                 ssh_key_path: Optional[str] = None,
                 agent_port: int = AGENT_PORT,
                 direct: bool = False) -> None:
        self._tunnel_proc: Optional[subprocess.Popen] = None
        if direct or head_ip in ('127.0.0.1', 'localhost'):
            self._base = f'http://127.0.0.1:{agent_port}'
        else:
            local_port = common_utils.find_free_port()
            runner = runner_lib.SSHCommandRunner(head_ip, ssh_user,
                                                 ssh_key_path)
            self._tunnel_proc = runner.tunnel(local_port, agent_port)
            self._base = f'http://127.0.0.1:{local_port}'
            self._wait_tunnel(local_port)
        self._session = requests.Session()

    def _wait_tunnel(self, local_port: int) -> None:
        """Until the tunnel's local port accepts a connection; the tunnel
        is closed and HeadNodeUnreachableError raised if it exits first or
        TUNNEL_TIMEOUT_S passes."""
        deadline = time.monotonic() + TUNNEL_TIMEOUT_S
        while True:
            try:
                with socket.create_connection(('127.0.0.1', local_port),
                                              timeout=1.0):
                    return
            except OSError:
                pass
            if (self._tunnel_proc.poll() is not None or
                    time.monotonic() > deadline):
                rc = self._tunnel_proc.poll()
                self.close()
                raise exceptions.HeadNodeUnreachableError(
                    f'SSH tunnel to the agent did not open 127.0.0.1:'
                    f'{local_port} (ssh exit {rc})')
            time.sleep(0.05)

    def close(self) -> None:
        if self._tunnel_proc is not None:
            self._tunnel_proc.terminate()
            self._tunnel_proc = None

    def __enter__(self) -> 'AgentClient':
        return self

    def __exit__(self, *_) -> None:
        self.close()

    # ----- API ---------------------------------------------------------------
    def _request(self, method: str, path: str, timeout: float = 30.0,
                 **kwargs) -> requests.Response:
        try:
            resp = self._session.request(method, self._base + path,
                                         timeout=timeout, **kwargs)
        except requests.ConnectionError as e:
            raise exceptions.HeadNodeUnreachableError(
                f'Agent unreachable at {self._base}: {e}') from e
        return resp

    def wait_ready(self, timeout_s: float = 60.0) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            try:
                if self.health().get('ok'):
                    return
            except exceptions.HeadNodeUnreachableError:
                pass
            time.sleep(1.0)
        raise exceptions.HeadNodeUnreachableError(
            f'Agent did not become ready in {timeout_s}s')

    def health(self) -> Dict[str, Any]:
        return self._request('GET', '/health', timeout=5.0).json()

    def submit_job(self, name: Optional[str],
                   spec: Dict[str, Any]) -> int:
        resp = self._request('POST', '/jobs/submit',
                             json={'name': name, 'spec': spec})
        return int(resp.json()['job_id'])

    def get_job(self, job_id: int) -> Optional[Dict[str, Any]]:
        resp = self._request('GET', f'/jobs/{job_id}')
        if resp.status_code == 404:
            return None
        return resp.json()

    def list_jobs(self) -> List[Dict[str, Any]]:
        return self._request('GET', '/jobs').json()

    def cancel_job(self, job_id: int) -> bool:
        return bool(self._request('POST',
                                  f'/jobs/{job_id}/cancel').json()
                    .get('cancelled'))

    def set_autostop(self, idle_minutes: int, down: bool) -> None:
        self._request('POST', '/autostop',
                      json={'idle_minutes': idle_minutes, 'down': down})

    def read_logs(self, job_id: int, phase: str = 'run', rank: int = 0,
                  offset: int = 0) -> bytes:
        resp = self._request(
            'GET', f'/jobs/{job_id}/logs',
            params={'phase': phase, 'rank': str(rank),
                    'offset': str(offset)})
        return resp.content

    def tail_logs(self, job_id: int, phase: str = 'run', rank: int = 0,
                  follow: bool = True, out=None) -> int:
        """Stream logs until the job terminates; returns its returncode."""
        import sys
        out = out or sys.stdout
        offset = 0
        while True:
            chunk = self.read_logs(job_id, phase, rank, offset)
            if chunk:
                offset += len(chunk)
                out.write(chunk.decode(errors='replace'))
                out.flush()
            job = self.get_job(job_id)
            if job is None:
                return 1
            from skypilot_tpu_torch.agent.job_queue import JobStatus
            status = JobStatus(job['status'])
            if status.is_terminal():
                # final drain
                chunk = self.read_logs(job_id, phase, rank, offset)
                if chunk:
                    out.write(chunk.decode(errors='replace'))
                    out.flush()
                rc = job.get('returncode')
                if rc is None:
                    # Terminal without a recorded rc (e.g. cancelled while
                    # PENDING): only SUCCEEDED may report 0.
                    return 0 if status is JobStatus.SUCCEEDED else 130
                return int(rc)
            if not follow:
                return 0
            time.sleep(0.5)
