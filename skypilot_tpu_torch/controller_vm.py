"""Shared dedicated-controller ("controller on VM") machinery.

Managed jobs and serve both support running their controllers OFF the
API server: a controller cluster is launched through the normal stack
and every verb ships to it as a short agent job
(jobs/remote_exec.py), carrying the caller's user/workspace identity so
RBAC runs controller-side; a persistent daemon there
(jobs/controller_daemon.py) drives the control loops.  This module owns
the mode resolution, cluster bring-up and verb transport that the two
front-ends (jobs/core.py, serve/core.py) share.
Parity: sky/jobs/server/core.py:494,:527 + sky/serve's dedicated
sky-serve-controller.
"""
from __future__ import annotations

import io
import json
import shlex
from typing import Any, Dict, List

from skypilot_tpu_torch import exceptions

JOBS_CONTROLLER_CLUSTER = 'skytpu-jobs-controller'
SERVE_CONTROLLER_CLUSTER = 'skytpu-serve-controller'


def mode(namespace: str) -> str:
    """'consolidation' (default) or 'vm' for `namespace` in
    {'jobs','serve'}.  remote_exec sets the env override ON the
    controller host so verbs it runs act locally instead of recursing."""
    import os
    if os.environ.get('SKYTPU_JOBS_LOCAL_MODE') == '1':
        return 'consolidation'
    from skypilot_tpu_torch import sky_config
    return str(sky_config.get_nested((namespace, 'controller', 'mode'),
                                     'consolidation'))


def ensure_cluster(cluster_name: str, namespace: str) -> None:
    from skypilot_tpu_torch import execution
    from skypilot_tpu_torch import global_user_state
    from skypilot_tpu_torch import resources as resources_lib
    from skypilot_tpu_torch import sky_config
    from skypilot_tpu_torch import task as task_lib
    from skypilot_tpu_torch.global_user_state import ClusterStatus
    record = global_user_state.get_cluster(cluster_name)
    if record is not None and record['status'] is ClusterStatus.UP:
        return
    res_cfg = sky_config.get_nested(
        (namespace, 'controller', 'resources'), {'cpus': '4+'})
    t = task_lib.Task(f'{namespace}-controller', run=None)
    t.set_resources(resources_lib.Resources.from_yaml_config(
        dict(res_cfg)))
    execution.launch(t, cluster_name, quiet_optimizer=True,
                     policy_operation=f'{namespace} controller launch')


def remote_call(cluster_name: str, args: List[str]) -> Dict[str, Any]:
    """Run one remote_exec verb on the controller cluster; parse the
    sentinel JSON line back out of the job logs.

    The acting user + workspace ride along as env so the verb executes
    AS this caller on the controller host — its consolidation-path code
    then runs the same RBAC/workspace guards it runs locally."""
    from skypilot_tpu_torch import execution
    from skypilot_tpu_torch import task as task_lib
    from skypilot_tpu_torch import users as users_lib
    from skypilot_tpu_torch import workspaces as workspaces_lib
    from skypilot_tpu_torch.backends import TpuVmBackend
    from skypilot_tpu_torch.jobs import remote_exec
    cmd = ('PYTHONPATH="$HOME/skytpu_runtime:$PYTHONPATH" '
           'SKYTPU_JOBS_LOCAL_MODE=1 '
           f'SKYTPU_USER={shlex.quote(users_lib.current_user().name)} '
           f'SKYTPU_WORKSPACE='
           f'{shlex.quote(workspaces_lib.active_workspace())} '
           f'python -m skypilot_tpu_torch.jobs.remote_exec '
           f'{shlex.join(args)}')
    t = task_lib.Task('controller-verb', run=cmd)
    job_id, handle = execution.exec_(t, cluster_name)
    backend = TpuVmBackend()
    buf = io.StringIO()
    rc = backend.tail_logs(handle, job_id, follow=True, out=buf)
    for line in buf.getvalue().splitlines():
        if line.startswith(remote_exec.SENTINEL):
            return json.loads(line[len(remote_exec.SENTINEL):])
    raise exceptions.ManagedJobStatusError(
        f'controller verb {args[0]!r} produced no result '
        f'(rc={rc}): {buf.getvalue()[-500:]}')


def controller_head_ip(cluster_name: str) -> str:
    from skypilot_tpu_torch import global_user_state
    record = global_user_state.get_cluster(cluster_name)
    if record is None:
        raise exceptions.ClusterDoesNotExistError(cluster_name)
    return record['handle'].head_ip or '127.0.0.1'
