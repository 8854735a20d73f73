"""Serve user API: up / down / status / replica logs
(capability parity: sky/serve/server/core.py up :28, down, status).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Union

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import global_user_state
from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch import task as task_lib
from skypilot_tpu_torch.serve import controller as controller_lib
from skypilot_tpu_torch.serve import serve_state
from skypilot_tpu_torch.serve.serve_state import ServiceStatus
from skypilot_tpu_torch.serve.service_spec import ServiceSpec
from skypilot_tpu_torch.utils import common_utils

logger = sky_logging.init_logger(__name__)


def _vm_mode() -> bool:
    from skypilot_tpu_torch import controller_vm
    return controller_vm.mode('serve') == 'vm'


def _serve_cluster_up() -> bool:
    """True = route remotely.  A controller record that EXISTS but is
    not UP is an error, not a silent fall-through to the (empty) local
    state — the service may well still be running on the controller
    host while this process knows nothing about it."""
    from skypilot_tpu_torch import controller_vm
    from skypilot_tpu_torch.global_user_state import ClusterStatus
    rec = global_user_state.get_cluster(
        controller_vm.SERVE_CONTROLLER_CLUSTER)
    if rec is None:
        return False          # nothing ever launched: local empty truth
    if rec['status'] is not ClusterStatus.UP:
        raise exceptions.ClusterNotUpError(
            f'serve controller cluster '
            f'{controller_vm.SERVE_CONTROLLER_CLUSTER!r} is '
            f'{rec["status"].value}; start it to manage its services')
    return True


def _remote(args):
    from skypilot_tpu_torch import controller_vm
    return controller_vm.remote_call(
        controller_vm.SERVE_CONTROLLER_CLUSTER, args)


def _remote_up(task: task_lib.Task, service_name: Optional[str],
               lb_port: Optional[int]) -> Dict[str, Any]:
    """Dedicated mode: the service controller + LB run on the serve
    controller cluster (parity: the reference's sky-serve-controller);
    the endpoint is the controller host's."""
    import base64
    import json
    from skypilot_tpu_torch import controller_vm
    controller_vm.ensure_cluster(
        controller_vm.SERVE_CONTROLLER_CLUSTER, 'serve')
    payload = base64.b64encode(json.dumps({
        'task': task.to_yaml_config(),
        'name': service_name,
        'lb_port': lb_port,
    }).encode()).decode()
    result = _remote(['serve_up', payload])
    host = controller_vm.controller_head_ip(
        controller_vm.SERVE_CONTROLLER_CLUSTER)
    endpoint = f'http://{host}:{result["port"]}'
    logger.info(f'Service {result["name"]!r} starting on dedicated '
                f'controller; endpoint: {endpoint}')
    return {'name': result['name'], 'endpoint': endpoint}


def up(task: task_lib.Task, service_name: Optional[str] = None,
       lb_port: Optional[int] = None) -> Dict[str, Any]:
    """Bring up a service; returns {'name', 'endpoint'}.

    The task must carry a `service:` section (readiness probe +
    replica policy).  The controller and load balancer run consolidated
    in this process (see serve/controller.py).
    """
    if task.service is None:
        raise exceptions.InvalidTaskError(
            'task has no `service:` section; add a readiness_probe and '
            'replica policy to serve it')
    if _vm_mode():
        return _remote_up(task, service_name, lb_port)
    spec = ServiceSpec.from_yaml_config(task.service)
    name = service_name or task.name or 'service'
    task_lib.Task(name)  # name validation
    port = lb_port if lb_port is not None else \
        common_utils.find_free_port()
    if not serve_state.add_service(name, spec.to_yaml_config(),
                                   task.to_yaml_config(), port):
        raise exceptions.ServeError(
            f'service {name!r} already exists; `serve down {name}` first '
            f'or pick another name')
    if os.environ.get('SKYTPU_JOBS_NO_CONTROLLERS') != '1':
        controller_lib.maybe_start_controllers()
    endpoint = f'http://127.0.0.1:{port}'
    logger.info(f'Service {name!r} starting; endpoint: {endpoint}')
    from skypilot_tpu_torch import usage_lib
    usage_lib.record('serve_up', service=name)
    return {'name': name, 'endpoint': endpoint}


def update(task: task_lib.Task,
           service_name: Optional[str] = None) -> Dict[str, Any]:
    """Rolling update of a live service to a new task/spec (parity:
    `sky serve update`): the stored spec is replaced under a bumped
    version; the controller surges new-version replicas and drains old
    ones only as replacements turn READY, so the endpoint never goes
    empty.  Returns {'name', 'version'}."""
    if task.service is None:
        raise exceptions.InvalidTaskError(
            'task has no `service:` section; add a readiness_probe and '
            'replica policy to serve it')
    if _vm_mode() and _serve_cluster_up():
        import base64
        import json
        payload = base64.b64encode(json.dumps({
            'task': task.to_yaml_config(), 'name': service_name,
        }).encode()).decode()
        result = _remote(['serve_update', payload])
        return {'name': service_name or task.name,
                'version': int(result['version'])}
    spec = ServiceSpec.from_yaml_config(task.service)
    name = service_name or task.name or 'service'
    version = serve_state.update_service(name, spec.to_yaml_config(),
                                         task.to_yaml_config())
    if version is None:
        raise exceptions.ServeError(
            f'service {name!r} not found or terminal; `serve up` it '
            f'instead')
    # The controller observes the version bump on its next tick; if it
    # died, re-adopt so the rollout actually runs (on a dedicated
    # controller host the persistent daemon does the adopting).
    if os.environ.get('SKYTPU_JOBS_NO_CONTROLLERS') != '1':
        controller_lib.maybe_start_controllers()
    logger.info(f'Service {name!r}: rolling update to v{version} '
                f'started.')
    from skypilot_tpu_torch import usage_lib
    usage_lib.record('serve_update', service=name, version=version)
    return {'name': name, 'version': version}


def down(service_name: str, purge: bool = False) -> None:
    """Tear a service down: replicas, LB, controller.

    purge: force-remove the record even if the controller is dead and
    cannot run the shutdown itself.
    """
    if _vm_mode() and _serve_cluster_up():
        _remote(['serve_down', service_name, '1' if purge else '0'])
        return
    rec = serve_state.get_service(service_name)
    if rec is None:
        raise exceptions.ServeError(f'service {service_name!r} not found')
    if rec['status'].is_terminal():
        serve_state.remove_service(service_name)
        return
    serve_state.set_service_status(service_name,
                                   ServiceStatus.SHUTTING_DOWN)
    # The controller thread observes SHUTTING_DOWN and cleans up; if it
    # died (or we're a fresh process after a restart), re-adopt so the
    # shutdown actually runs (dedicated hosts: the daemon adopts).
    if os.environ.get('SKYTPU_JOBS_NO_CONTROLLERS') != '1':
        controller_lib.maybe_start_controllers()
    if purge:
        from skypilot_tpu_torch.serve.replica_managers import ReplicaManager
        spec = ServiceSpec.from_yaml_config(rec['spec'])
        t = task_lib.Task.from_yaml_config(rec['task_config'])
        ReplicaManager(service_name, spec, t).terminate_all()
        serve_state.remove_service(service_name)


def status(service_names: Optional[Union[str, List[str]]] = None
           ) -> List[Dict[str, Any]]:
    """Services + their replicas (parity: sky serve status)."""
    if isinstance(service_names, str):
        service_names = [service_names]
    if _vm_mode() and _serve_cluster_up():
        from skypilot_tpu_torch import controller_vm
        from skypilot_tpu_torch.serve.serve_state import ReplicaStatus
        host = controller_vm.controller_head_ip(
            controller_vm.SERVE_CONTROLLER_CLUSTER)
        args = ['serve_status'] + (
            [service_names[0]] if service_names and
            len(service_names) == 1 else [])
        records = []
        for rec in _remote(args)['services']:
            if service_names and rec['name'] not in service_names:
                continue
            rec['status'] = ServiceStatus(rec['status'])
            rec['replicas'] = [
                dict(r, status=ReplicaStatus(r['status']))
                for r in rec['replicas']]
            # The controller reports loopback; callers need the
            # controller HOST's endpoint.
            rec['endpoint'] = rec['endpoint'].replace(
                '127.0.0.1', host)
            records.append(rec)
        return records
    out = []
    for rec in serve_state.list_services():
        if service_names and rec['name'] not in service_names:
            continue
        replicas = serve_state.get_replicas(rec['name'],
                                            include_terminal=True)
        out.append({
            'name': rec['name'],
            'status': rec['status'],
            'endpoint': f'http://127.0.0.1:{rec["lb_port"]}',
            'failure_reason': rec['failure_reason'],
            'replicas': replicas,
        })
    return out


def tail_replica_logs(service_name: str, replica_id: int,
                      follow: bool = False) -> int:
    rec = serve_state.get_replica(service_name, replica_id)
    if rec is None:
        raise exceptions.ServeError(
            f'replica {replica_id} of service {service_name!r} not found')
    record = global_user_state.get_cluster(rec['cluster_name'])
    if record is None or rec['cluster_job_id'] is None:
        raise exceptions.ClusterDoesNotExistError(
            f'replica {replica_id} of {service_name!r} has no live '
            f'cluster (status={rec["status"].value})')
    from skypilot_tpu_torch.backends import TpuVmBackend
    return TpuVmBackend().tail_logs(record['handle'],
                                    rec['cluster_job_id'], follow=follow)
