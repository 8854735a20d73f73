"""TpuVmBackend — the execution backend (parity: CloudVmRayBackend,
cloud_vm_ray_backend.py:2829, minus Ray).

provision: per-cluster lock → reuse-or-provision with stockout failover →
wait READY → bootstrap the head agent → persist handle.  execute: build a
gang job spec (every slice host runs `run` with distributed env injected)
and submit to the agent over HTTP(S over SSH tunnel).  All cluster state
mutations happen under the cluster lock, mirroring the reference's
`_locked_provision` (cloud_vm_ray_backend.py:3071).

Counterpart of `skypilot_tpu/backends/tpu_vm_backend.py` (same class
name, so a reader finds its twin).  Where it differs:
  - the agent it bootstraps is the port's, `python -m
    skypilot_tpu_torch.agent.server`, with the port's parent directory on
    PYTHONPATH;
  - the remote bootstrap's `pkill` matches the agent's own command line
    (AGENT_PKILL_PATTERN): the JAX module's `pkill -f` of its agent's
    module name also matches the shell that runs the bootstrap, whose
    command line names the module, and kills it before it starts the
    agent;
  - `_job_spec` sets `chips_per_host` from a GPU resource's card count
    (H100:N gives N) as from a TPU slice's chips per host, and marks a
    `docker:` task on a GPU resource `docker_gpus`, so the gang's
    container gets the cards (provision/docker_utils.py).
"""
from __future__ import annotations

import os
import shlex
import signal
import subprocess
import sys
import time
from typing import Any, Dict, Optional

from skypilot_tpu_torch import clouds as clouds_lib
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import global_user_state
from skypilot_tpu_torch import provision as provision_lib
from skypilot_tpu_torch import resources as resources_lib
from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch import task as task_lib
from skypilot_tpu_torch.agent import client as agent_client_lib
from skypilot_tpu_torch.backends import backend as backend_lib
from skypilot_tpu_torch.global_user_state import ClusterHandle, ClusterStatus
from skypilot_tpu_torch.provision import failover
from skypilot_tpu_torch.optimizer import OptimizeTarget
from skypilot_tpu_torch.provision.common import ProvisionConfig
from skypilot_tpu_torch.utils import common_utils
from skypilot_tpu_torch.utils import command_runner as runner_lib
from skypilot_tpu_torch.utils import locks

logger = sky_logging.init_logger(__name__)

# What the remote bootstrap's `pkill -f` stops: a running agent, whose
# command line starts with `python... -m skypilot_tpu_torch.agent.server`.
# Anchored so that it does not match the shell running the bootstrap,
# whose own command line holds the module's name.
AGENT_PKILL_PATTERN = ('^[^ ]*python[^ ]* -m '
                       'skypilot_tpu_torch[.]agent[.]server( |$)')

_WORKDIR_DEST = '~/sky_workdir'


class TpuVmBackend(backend_lib.Backend):
    NAME = 'tpu_vm'

    # ----- provision ---------------------------------------------------------
    def provision(self, task: task_lib.Task, cluster_name: str,
                  dryrun: bool = False,
                  retry_until_up: bool = False,
                  blocked_resources: Optional[list] = None,
                  minimize: Optional[OptimizeTarget] = None,
                  ) -> Optional[ClusterHandle]:
        if dryrun:
            return None
        with locks.cluster_lock(cluster_name):
            existing = global_user_state.get_cluster(cluster_name)
            if existing is not None:
                handle = existing['handle']
                if not self._check_reusable(handle, task):
                    raise exceptions.ResourcesMismatchError(
                        f'Cluster {cluster_name!r} exists with different '
                        f'resources ({existing["resources"]}); use a new '
                        'name or down it first.')
                if existing['status'] is ClusterStatus.UP:
                    logger.info(f'Reusing cluster {cluster_name!r}.')
                    # Runtime version pin: a client upgraded since this
                    # cluster launched must not submit jobs to an old
                    # agent — re-ship the runtime and restart the agent
                    # first (parity: the reference pins its wheel
                    # version, sky/backends/wheel_utils.py).
                    self._ensure_agent_version(handle)
                    return handle
                # STOPPED/INIT: restart in place — same cloud/zone, so the
                # existing nodes are reused instead of orphaned by a fresh
                # failover provision landing elsewhere.
                return self._restart_locked(handle)
            return self._provision_locked(task, cluster_name,
                                          blocked_resources,
                                          retry_until_up=retry_until_up,
                                          minimize=minimize)

    def _ensure_agent_version(self, handle: ClusterHandle) -> None:
        """Re-bootstrap the agent when its runtime version differs from
        this client's (version drift on a long-lived cluster)."""
        import skypilot_tpu_torch
        client = self._agent_client(handle)
        try:
            agent_version = client.health().get('version')
        except Exception:  # pylint: disable=broad-except
            agent_version = None   # unreachable: bootstrap will restart
        finally:
            client.close()
        if agent_version == skypilot_tpu_torch.__version__:
            return
        logger.info(
            f'Cluster {handle.cluster_name!r} agent runtime is '
            f'{agent_version or "unreachable"}, client is '
            f'{skypilot_tpu_torch.__version__}; re-shipping runtime and '
            f'restarting the agent.')
        self._bootstrap_agent(handle)
        # Persist the refreshed handle (new agent pid for local).
        record = global_user_state.get_cluster(handle.cluster_name)
        if record is not None:
            global_user_state.add_or_update_cluster(
                handle.cluster_name, handle, record['status'])
        client = self._agent_client(handle)
        try:
            fresh = client.health().get('version')
        finally:
            client.close()
        if fresh != skypilot_tpu_torch.__version__:
            raise exceptions.HeadNodeUnreachableError(
                f'agent on {handle.cluster_name!r} still reports '
                f'runtime {fresh!r} after re-shipping (client '
                f'{skypilot_tpu_torch.__version__}); down and relaunch')

    def _check_reusable(self, handle: ClusterHandle,
                        task: task_lib.Task) -> bool:
        launched = handle.launched_resources()
        return any(r.less_demanding_than(launched) for r in task.resources)

    def _restart_locked(self, handle: ClusterHandle) -> ClusterHandle:
        """Restart a stopped/unhealthy cluster on its original placement."""
        config = ProvisionConfig(
            cluster_name=handle.cluster_name,
            # One provisioning node per slice: multislice (xN) requests
            # restart all N slices of every logical node.
            num_nodes=(handle.num_nodes *
                       handle.launched_resources().num_slices),
            resources_config=dict(handle.resources_config),
            region=handle.region,
            zone=handle.zone,
        )
        provision_lib.run_instances(handle.cloud, config)
        provision_lib.wait_instances(handle.cloud, handle.cluster_name,
                                     region=handle.region,
                                     zone=handle.zone)
        info = provision_lib.get_cluster_info(handle.cloud,
                                              handle.cluster_name,
                                              region=handle.region,
                                              zone=handle.zone)
        handle.node_ips = info.node_ips
        self._bootstrap_agent(handle)
        global_user_state.add_or_update_cluster(handle.cluster_name, handle,
                                                ClusterStatus.UP)
        global_user_state.add_cluster_event(handle.cluster_name, 'restart',
                                            f'{handle.cloud}/{handle.zone}')
        return handle

    def _provision_locked(self, task: task_lib.Task,
                          cluster_name: str,
                          blocked_resources: Optional[list] = None,
                          retry_until_up: bool = False,
                          minimize: Optional[OptimizeTarget] = None,
                          ) -> ClusterHandle:
        def provision_fn(candidate: resources_lib.Resources):
            authorized_key = None
            if candidate.cloud != 'local':
                from skypilot_tpu_torch import authentication
                _, authorized_key = authentication.get_or_generate_keys()
            from skypilot_tpu_torch import volumes as volumes_lib
            try:
                task_volumes = volumes_lib.validate_task_volumes(
                    task, candidate)
            except exceptions.InvalidTaskError as e:
                # Volume-incompatible *candidate*, not a broken task:
                # surface inside the failover taxonomy so the engine
                # moves to the next placement (one of which may host
                # the volume) instead of aborting the launch.
                raise exceptions.ProvisionError(str(e)) from e
            config = ProvisionConfig(
                cluster_name=cluster_name,
                # Multislice (tpu-...xN): each slice is its own
                # provisioning node — N queued-resource creates that
                # succeed or fail over as one atomic placement (the
                # failover engine's cleanup_fn deletes partial slices).
                num_nodes=task.num_nodes * candidate.num_slices,
                resources_config=candidate.to_yaml_config(),
                region=candidate.region,
                zone=candidate.zone,
                authorized_key=authorized_key,
                labels=candidate.labels or {},
                ports=candidate.ports or [],
                volumes=task_volumes,
            )
            record = provision_lib.run_instances(candidate.cloud, config)
            provision_lib.wait_instances(candidate.cloud, cluster_name,
                                         region=record.region,
                                         zone=record.zone)
            return record

        def cleanup_fn(candidate: resources_lib.Resources):
            # Delete partial nodes / parked queued-resources in the failed
            # zone before failing over elsewhere.
            provision_lib.terminate_instances(candidate.cloud,
                                              cluster_name,
                                              region=candidate.region,
                                              zone=candidate.zone)

        global_user_state.add_cluster_event(cluster_name, 'provision_start',
                                            '')
        result = failover.provision_with_retries(
            task, cluster_name, provision_fn, cleanup_fn=cleanup_fn,
            blocked_resources=blocked_resources,
            retry_until_up=retry_until_up,
            minimize=(minimize if minimize is not None
                      else failover.OptimizeTarget.COST))
        candidate = result.resources
        info = provision_lib.get_cluster_info(candidate.cloud, cluster_name,
                                              region=result.record.region,
                                              zone=result.record.zone)
        handle = ClusterHandle(
            cluster_name=cluster_name,
            cloud=candidate.cloud,
            region=result.record.region,
            zone=result.record.zone,
            resources_config=candidate.to_yaml_config(),
            num_nodes=task.num_nodes,
            node_ips=info.node_ips,
            instance_names=result.record.instance_ids,
            ssh_user=info.ssh_user,
            # Provider-mandated key first (ssh pools carry their own
            # identity_file — the framework key is never injected on
            # BYO hosts), else the framework-generated key.
            ssh_key_path=(os.path.expanduser(info.ssh_key_path)
                          if info.ssh_key_path else
                          os.path.expanduser('~/.ssh/sky-key')
                          if candidate.cloud != 'local' else None),
            agent_port=(common_utils.find_free_port() if candidate.cloud == 'local'
                        else agent_client_lib.AGENT_PORT),
        )
        global_user_state.add_or_update_cluster(cluster_name, handle,
                                               ClusterStatus.INIT,
                                               is_launch=True)
        self._bootstrap_agent(handle)
        global_user_state.add_or_update_cluster(cluster_name, handle,
                                               ClusterStatus.UP)
        global_user_state.add_cluster_event(
            cluster_name, 'provision_done',
            f'{candidate.cloud}/{handle.zone}')
        return handle

    # ----- agent bootstrap ---------------------------------------------------
    def _agent_home(self, handle: ClusterHandle) -> str:
        if handle.cloud == 'local':
            return os.path.expanduser(
                f'~/.skytpu/agent-{handle.cluster_name}')
        return '~/.skytpu/agent'

    def _bootstrap_agent(self, handle: ClusterHandle) -> None:
        """Start the head-host agent (parity: start_skylet_on_head_node,
        instance_setup.py:490)."""
        if handle.cloud == 'local':
            # A re-bootstrap (version drift) must not race the old agent
            # for the port.
            old_pid = handle.extras.get('agent_pid')
            if old_pid:
                try:
                    os.kill(int(old_pid), signal.SIGTERM)
                    # Wait it out: the new agent binds the same port,
                    # and a draining old agent would both steal the bind
                    # and answer health checks with the old version.
                    deadline = time.time() + 10
                    while time.time() < deadline:
                        try:
                            os.kill(int(old_pid), 0)
                        except ProcessLookupError:
                            break
                        time.sleep(0.1)
                    else:
                        os.kill(int(old_pid), signal.SIGKILL)
                except (ProcessLookupError, ValueError):
                    pass
            env = dict(os.environ)
            env['SKYTPU_AGENT_HOME'] = self._agent_home(handle)
            # The agent child must import skypilot_tpu_torch even when the
            # parent got it via sys.path manipulation rather than an
            # install.
            import skypilot_tpu_torch
            pkg_parent = os.path.dirname(os.path.dirname(
                os.path.abspath(skypilot_tpu_torch.__file__)))
            env['PYTHONPATH'] = (pkg_parent + os.pathsep +
                                 env.get('PYTHONPATH', '')).rstrip(
                                     os.pathsep)
            proc = subprocess.Popen(
                [sys.executable, '-m', 'skypilot_tpu_torch.agent.server',
                 '--port', str(handle.agent_port),
                 '--cluster-name', handle.cluster_name,
                 '--cloud', handle.cloud,
                 '--region', str(handle.region),
                 '--zone', str(handle.zone)],
                env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                start_new_session=True)
            handle.extras['agent_pid'] = proc.pid
            # Registry for test harnesses: every locally spawned agent PID
            # is appended so a session-scoped fixture can reap leaks (the
            # agent is detached via start_new_session and survives its
            # spawner otherwise).
            registry = os.environ.get('SKYTPU_AGENT_PID_FILE')
            if registry:
                try:
                    with open(registry, 'a', encoding='utf-8') as f:
                        f.write(f'{proc.pid}\n')
                except OSError:
                    pass
        else:
            runner = runner_lib.SSHCommandRunner(handle.head_ip,
                                                 handle.ssh_user,
                                                 handle.ssh_key_path)
            # Ship the framework to the head host, then start the agent
            # detached (survives the SSH session).
            pkg_dir = os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))
            runner.run('mkdir -p ~/skytpu_runtime ~/.skytpu')
            runner.rsync(pkg_dir, '~/skytpu_runtime/', up=True)
            runner.run(
                f'pkill -f {shlex.quote(AGENT_PKILL_PATTERN)} || true; '
                'cd ~/skytpu_runtime && '
                'nohup python3 -m skypilot_tpu_torch.agent.server --port '
                f'{handle.agent_port} '
                f'--cluster-name {handle.cluster_name} '
                f'--cloud {handle.cloud} --region {handle.region} '
                f'--zone {handle.zone} > ~/.skytpu/agent.log 2>&1 &')
        client = self._agent_client(handle)
        try:
            client.wait_ready(timeout_s=60.0)
        finally:
            client.close()

    def _agent_client(self,
                      handle: ClusterHandle) -> agent_client_lib.AgentClient:
        if handle.cloud == 'local':
            return agent_client_lib.AgentClient(
                '127.0.0.1', agent_port=handle.agent_port, direct=True)
        return agent_client_lib.AgentClient(handle.head_ip,
                                            handle.ssh_user,
                                            handle.ssh_key_path,
                                            handle.agent_port)

    # ----- sync / setup ------------------------------------------------------
    def _host_runners(self, handle: ClusterHandle):
        if handle.cloud == 'local':
            return [runner_lib.LocalProcessRunner()]
        return [
            runner_lib.SSHCommandRunner(ip, handle.ssh_user,
                                        handle.ssh_key_path)
            for ip in handle.all_host_ips
        ]

    def _workdir_dest(self, handle: ClusterHandle) -> str:
        if handle.cloud == 'local':
            return os.path.join(self._agent_home(handle), 'workdir')
        return _WORKDIR_DEST

    def _for_all_hosts(self, handle: ClusterHandle, fn) -> None:
        """Run fn(runner) on every host CONCURRENTLY.  A v5p-256 slice
        has 16+ hosts; serial per-host rsync would multiply sync
        latency by host count (ref parallelizes post-provision setup
        the same way: provisioner.py:121-438 _parallel_...).  The first
        host's failure propagates after all complete."""
        runners = self._host_runners(handle)
        if not runners:
            return            # the old serial loop was a no-op too
        if len(runners) == 1:
            fn(runners[0])
            return
        import concurrent.futures
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(16, len(runners))) as pool:
            futures = [pool.submit(fn, r) for r in runners]
            for f in futures:
                f.result()

    def sync_workdir(self, handle: ClusterHandle, workdir: str) -> None:
        from skypilot_tpu_torch.data import storage_utils
        src = os.path.expanduser(workdir).rstrip('/') + '/'
        dest = self._workdir_dest(handle) + '/'
        excludes = storage_utils.load_excludes(src)
        self._for_all_hosts(
            handle,
            lambda runner: runner.rsync(src, dest, up=True,
                                        excludes=excludes))

    def sync_file_mounts(self, handle: ClusterHandle,
                         file_mounts: Dict[str, str]) -> None:
        for dst, src in (file_mounts or {}).items():
            if src.startswith(('gs://', 's3://', 'r2://')):
                from skypilot_tpu_torch.data import storage as storage_lib
                storage_lib.fetch_bucket_to_cluster(self, handle, src, dst)
                continue
            src_path = os.path.expanduser(src)
            if os.path.isdir(src_path):
                # rsync trailing-slash semantics: sync *contents* to dst,
                # not dst/<basename>.
                src_path = src_path.rstrip('/') + '/'
            if handle.cloud == 'local':
                dst = os.path.join(self._agent_home(handle),
                                   dst.lstrip('/~'))

            def sync_one(runner, src_path=src_path, dst=dst):
                runner.run(f'mkdir -p "$(dirname {shlex.quote(dst)})"')
                runner.rsync(src_path, dst, up=True)

            self._for_all_hosts(handle, sync_one)

    def setup(self, handle: ClusterHandle, task: task_lib.Task) -> None:
        """Setup runs synchronously on all hosts (via gang spec with only
        setup; run phase empty)."""
        if not task.setup:
            return
        job_spec = self._job_spec(handle, task, setup_only=True)
        client = self._agent_client(handle)
        try:
            job_id = client.submit_job(f'{task.name or "task"}-setup',
                                       job_spec)
            self._wait_job(client, job_id)
            job = client.get_job(job_id)
            from skypilot_tpu_torch.agent.job_queue import JobStatus
            if JobStatus(job['status']) is not JobStatus.SUCCEEDED:
                raise exceptions.ClusterSetupError(
                    f'setup failed with status {job["status"]} '
                    f'(rc={job.get("returncode")})')
        finally:
            client.close()

    # ----- execute -----------------------------------------------------------
    def _job_spec(self, handle: ClusterHandle, task: task_lib.Task,
                  setup_only: bool = False) -> Dict[str, Any]:
        res = handle.launched_resources()
        tpu = res.tpu
        # Accelerators per host: a TPU slice's chips, else the GPU count
        # (H100:N gives N); the gang injects it as SKYTPU_NUM_TPU_CHIPS.
        if tpu:
            chips_per_host = tpu.chips_per_host
        elif res.accelerators:
            chips_per_host = int(res.accelerator_count)
        else:
            chips_per_host = 0
        spec: Dict[str, Any] = {
            'nodes': handle.node_ips or [['127.0.0.1']],
            # Explicit multislice (tpu-...xN) ONLY: every provisioned node
            # is one ICI slice and the gang injects the MEGASCALE contract
            # so the slices form one DCN-connected XLA computation.  Plain
            # num_nodes>1 clusters stay independent slices (no MEGASCALE).
            'num_slices': (len(handle.node_ips)
                           if res.num_slices > 1 and handle.node_ips
                           else 1),
            'chips_per_host': chips_per_host,
            'is_local': handle.cloud == 'local',
            'ssh_user': handle.ssh_user,
            'ssh_key_path': handle.ssh_key_path,
            'envs': task.envs,
            'secrets': task.secrets,
            'workdir_dest': (self._workdir_dest(handle)
                             if task.workdir else None),
        }
        # docker:<image> task runtime: the gang starts a container per
        # host and runs setup/run inside it, with the cards for a GPU
        # resource (provision/docker_utils.py; ref
        # sky/provision/docker_utils.py).
        from skypilot_tpu_torch.provision import docker_utils
        docker_image = docker_utils.image_from_resources(res.image_id)
        if docker_image:
            spec['docker_image'] = docker_image
            if res.accelerators and not tpu:
                spec['docker_gpus'] = True
        if setup_only:
            spec['setup'] = task.setup
        else:
            if isinstance(task.run, str):
                spec['run'] = task.run
            elif task.run is None:
                spec['run'] = ''
        return spec

    def execute(self, handle: ClusterHandle, task: task_lib.Task,
                detach_run: bool = False) -> Optional[int]:
        if callable(task.run):
            raise exceptions.NotSupportedError(
                'callable run is executed client-side; only str run is '
                'submitted to clusters')
        spec = self._job_spec(handle, task)
        client = self._agent_client(handle)
        try:
            job_id = client.submit_job(task.name, spec)
            global_user_state.add_cluster_event(
                handle.cluster_name, 'job_submit', f'job {job_id}')
            if not detach_run:
                rc = client.tail_logs(job_id)
                if rc != 0:
                    raise exceptions.JobExitNonZeroError(
                        f'Job {job_id} failed with rc={rc}', rc)
            return job_id
        finally:
            client.close()

    def _wait_job(self, client: agent_client_lib.AgentClient,
                  job_id: int, timeout_s: float = 3600.0) -> None:
        from skypilot_tpu_torch.agent.job_queue import JobStatus
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            job = client.get_job(job_id)
            if job and JobStatus(job['status']).is_terminal():
                return
            time.sleep(0.5)
        raise exceptions.JobNotFoundError(
            f'job {job_id} did not finish in {timeout_s}s')

    # ----- lifecycle ---------------------------------------------------------
    def teardown(self, handle: ClusterHandle,
                 terminate: bool = True) -> None:
        with locks.cluster_lock(handle.cluster_name):
            if terminate:
                provision_lib.terminate_instances(handle.cloud,
                                                  handle.cluster_name,
                                                  region=handle.region,
                                                  zone=handle.zone)
            else:
                res = handle.launched_resources()
                clouds_lib.get_cloud(handle.cloud).check_capability(
                    clouds_lib.CloudCapability.STOP, res)
                provision_lib.stop_instances(handle.cloud,
                                             handle.cluster_name,
                                             region=handle.region,
                                             zone=handle.zone)
            if handle.cloud == 'local':
                pid = handle.extras.get('agent_pid')
                if pid:
                    try:
                        os.kill(pid, 15)
                    except ProcessLookupError:
                        pass
            if terminate:
                global_user_state.remove_cluster(handle.cluster_name)
            else:
                global_user_state.set_cluster_status(handle.cluster_name,
                                                     ClusterStatus.STOPPED)

    def cancel_job(self, handle: ClusterHandle, job_id: int) -> bool:
        client = self._agent_client(handle)
        try:
            return client.cancel_job(job_id)
        finally:
            client.close()

    def job_queue(self, handle: ClusterHandle):
        client = self._agent_client(handle)
        try:
            return client.list_jobs()
        finally:
            client.close()

    def tail_logs(self, handle: ClusterHandle, job_id: int,
                  follow: bool = True, out=None) -> int:
        client = self._agent_client(handle)
        try:
            return client.tail_logs(job_id, follow=follow, out=out)
        finally:
            client.close()
