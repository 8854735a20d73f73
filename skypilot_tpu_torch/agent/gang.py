"""Gang executor: run one job on every host of the cluster, no Ray.

Counterpart of `skypilot_tpu/agent/gang.py`: the same processes, one per
host, driven from the head agent over SSH (remote hosts) or subprocess
(local / head itself), and the same failure policy: any host's non-zero
exit fails the whole gang and kills the survivors (a dead rank wedges
the collectives of the others; the managed-jobs layer handles
recreate-and-resume).

Env injected per host (the JAX module's `SKYTPU_*` block, from
`parallel/distributed.py`'s `distributed_env_from_cluster`):
  SKYTPU_NUM_NODES         total host count
  SKYTPU_NODE_RANK         global host rank
  SKYTPU_NODE_IPS          newline-separated host ips
  SKYTPU_COORDINATOR_ADDR  head_ip:8476 (torch.distributed's tcp:// rendezvous)
  SKYTPU_NUM_TPU_CHIPS     accelerators per host
so user code just calls
skypilot_tpu_torch.parallel.maybe_initialize_distributed().

Where it differs from the JAX module:
  - no MEGASCALE_* / TPU_WORKER_* block: that is libtpu's multislice
    contract, and nothing of PyTorch reads it (parallel/distributed.py);
  - SKYTPU_NUM_TPU_CHIPS carries the number of cards per host for a GPU
    resource (H100:N gives N), as it carries a TPU slice's chips per host
    (the backend's job spec sets `chips_per_host` either way);
  - a `docker_image` spec's container gets the host's cards when the
    spec says `docker_gpus` (the backend sets it for a GPU resource):
    provision/docker_utils.py's `--gpus all` in place of `--privileged`.

The head agent imports this module, and the agent never touches a card:
it imports neither torch nor JAX (`parallel.distributed` keeps torch
inside the functions that join a group).
"""
from __future__ import annotations

import os
import shlex
import subprocess
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.utils import command_runner as runner_lib

logger = sky_logging.init_logger(__name__)


def build_host_env(host_ips: List[str], host_rank: int,
                   chips_per_host: int,
                   extra_env: Optional[Dict[str, str]] = None
                   ) -> Dict[str, str]:
    """Per-host env: the SKYTPU_* distributed wiring and the host's
    accelerator count."""
    env = distributed.distributed_env_from_cluster(host_ips, host_rank)
    env['SKYTPU_NUM_TPU_CHIPS'] = str(chips_per_host)
    if extra_env:
        env.update(extra_env)
    return env


class GangJob:
    """One job's gang execution across hosts."""

    def __init__(self, job_id: int, spec: Dict[str, Any],
                 log_dir: str) -> None:
        self.job_id = job_id
        self.spec = spec
        self.log_dir = log_dir
        self._procs: List[subprocess.Popen] = []
        self._cancelled = False

    def _runner_for(self, ip: str) -> runner_lib.CommandRunner:
        if self.spec.get('is_local', False) or ip in ('127.0.0.1',
                                                      'localhost'):
            return runner_lib.LocalProcessRunner(
                workdir=self.spec.get('workdir_dest'))
        return runner_lib.SSHCommandRunner(
            ip, self.spec.get('ssh_user', 'skytpu'),
            self.spec.get('ssh_key_path'))

    @property
    def host_ips(self) -> List[str]:
        # nodes: [[host ips of node 0], [host ips of node 1], ...]
        return [ip for node in self.spec.get('nodes', [['127.0.0.1']])
                for ip in node]

    def run_docker_bootstrap(self) -> int:
        """Start the task container on every host (docker:<image>
        tasks; provision/docker_utils.py).  Idempotent per host."""
        image = self.spec.get('docker_image')
        if not image:
            return 0
        from skypilot_tpu_torch.provision import docker_utils
        cmd = docker_utils.bootstrap_command(
            image, self.spec.get('workdir_dest'),
            gpus=bool(self.spec.get('docker_gpus')))
        return self._fan_out(cmd, phase='docker-init')

    def run_setup(self) -> int:
        setup = self.spec.get('setup')
        if not setup:
            return 0
        return self._fan_out(setup, phase='setup')

    def run(self) -> int:
        run_cmd = self.spec.get('run')
        if not run_cmd:
            return 0
        return self._fan_out(run_cmd, phase='run', inject_rank_env=True)

    def _fan_out(self, cmd: str, phase: str,
                 inject_rank_env: bool = False) -> int:
        ips = self.host_ips
        chips = int(self.spec.get('chips_per_host', 0))
        envs = dict(self.spec.get('envs', {}))
        envs.update(self.spec.get('secrets', {}))
        if self._cancelled:
            return 130
        procs = []
        for rank, ip in enumerate(ips):
            env = dict(envs)
            if inject_rank_env:
                env.update(build_host_env(ips, rank, chips))
            log_path = os.path.join(self.log_dir, f'{phase}-{rank}.log')
            runner = self._runner_for(ip)
            workdir = self.spec.get('workdir_dest')
            full_cmd = cmd
            docker_image = self.spec.get('docker_image')
            if docker_image and phase != 'docker-init':
                # Task phases execute INSIDE the container; env must
                # cross the docker exec boundary (a host-side export
                # would not), so it rides the wrapped command and the
                # runner gets none.
                from skypilot_tpu_torch.provision import docker_utils
                full_cmd = docker_utils.wrap(cmd, env=env,
                                             workdir=workdir)
                env = {}
            elif workdir and not isinstance(
                    runner, runner_lib.LocalProcessRunner):
                full_cmd = f'cd {shlex.quote(workdir)} && {cmd}'
            procs.append(runner.popen(full_cmd, env=env,
                                      log_path=log_path))
        self._procs = procs
        # Monitor loop: cancellable, and any host's failure is terminal —
        # surviving ranks are killed immediately (a dead host wedges the
        # ICI mesh; peers would otherwise block in collectives forever).
        # Every exit path joins the log pumps BEFORE returning: the
        # status callback (and the one-shot log ship behind it) fires the
        # moment this returns, so a child that exited with its last lines
        # still in the pipe would otherwise ship truncated/empty logs.
        import time
        while True:
            if self._cancelled:
                self._kill_all()
                self._join_pumps(procs)
                return 130
            rcs = [p.poll() for p in procs]
            first_bad = next(
                (rc for rc in rcs if rc is not None and rc != 0), None)
            if first_bad is not None:
                self._kill_all()
                self._join_pumps(procs)
                return first_bad
            if all(rc is not None for rc in rcs):
                self._join_pumps(procs)
                return 0
            time.sleep(0.2)

    @staticmethod
    def _join_pumps(procs: List[subprocess.Popen],
                    deadline: float = 5.0) -> None:
        """Drain all log pumps under ONE shared deadline (not per-proc:
        a gang of N hosts must not stack N timeouts onto terminal-status
        latency when a job leaves a background child holding its pipe).
        """
        import time
        t0 = time.monotonic()
        for p in procs:
            left = deadline - (time.monotonic() - t0)
            if not runner_lib.join_pump(p, timeout=left):
                logger.warning(
                    'log pump still draining at terminal status (a '
                    'background child is holding the output pipe); '
                    'terminal-time log ship may be missing its output')

    def _kill_all(self) -> None:
        import signal
        for p in self._procs:
            if p.poll() is None:
                try:
                    # whole process group (popen uses start_new_session)
                    os.killpg(p.pid, signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    pass
        deadline = 5.0
        import time
        t0 = time.time()
        while time.time() - t0 < deadline:
            if all(p.poll() is not None for p in self._procs):
                return
            time.sleep(0.1)
        for p in self._procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass

    def cancel(self) -> None:
        self._cancelled = True


def run_gang_job(job_id: int, spec: Dict[str, Any], log_dir: str,
                 status_cb, job: Optional['GangJob'] = None) -> int:
    """Execute setup then run; status_cb(status_str, rc) on transitions.
    Returns the final returncode."""
    from skypilot_tpu_torch.agent import job_queue
    os.makedirs(log_dir, exist_ok=True)
    if job is None:
        job = GangJob(job_id, spec, log_dir)
    status_cb(job_queue.JobStatus.SETTING_UP, None)
    rc = job.run_docker_bootstrap()
    if rc == 0:
        rc = job.run_setup()
    if job._cancelled:  # pylint: disable=protected-access
        status_cb(job_queue.JobStatus.CANCELLED, rc)
        return rc
    if rc != 0:
        status_cb(job_queue.JobStatus.FAILED_SETUP, rc)
        return rc
    status_cb(job_queue.JobStatus.RUNNING, None)
    rc = job.run()
    if job._cancelled:  # pylint: disable=protected-access
        status_cb(job_queue.JobStatus.CANCELLED, rc)
        return rc
    status_cb(job_queue.JobStatus.SUCCEEDED if rc == 0 else
              job_queue.JobStatus.FAILED, rc)
    return rc
