"""The cancel and service cases of the port's dedicated ("controller on
VM") mode, from tests/test_controller_vm.py, split from
tests/test_torch_controller_vm.py (whose fixtures and helpers they use)
so that two xdist workers run the two files side by side.

Every process a case spawned is killed at the module's end
(`reap_marked`, tests/torch_control.py); each case kills its daemon.
"""
from skypilot_tpu_torch.jobs import core as jobs_core
from skypilot_tpu_torch.jobs.state import ManagedJobStatus
from skypilot_tpu_torch.jobs import controller_daemon
from skypilot_tpu_torch.resources import Resources
from skypilot_tpu_torch.task import Task

from test_torch_controller_vm import (_local_task, _wait,  # noqa: F401
                                      serve_vm_mode, vm_mode)
from torch_control import port_home, reap_marked, wait_for  # noqa: F401


def test_vm_mode_cancel(vm_mode):
    gate = vm_mode / 'never'
    job_id = jobs_core.launch(_local_task(
        f'while [ ! -f {gate} ]; do sleep 0.1; done'))
    _wait(job_id, (ManagedJobStatus.RUNNING,))
    assert jobs_core.cancel(job_id)
    _wait(job_id, (ManagedJobStatus.CANCELLED,))



_REPLICA_RUN = (
    "python3 -c \"import http.server, os\n"
    "class H(http.server.BaseHTTPRequestHandler):\n"
    "    def do_GET(self):\n"
    "        self.send_response(200)\n"
    "        self.send_header('Content-Length', '2')\n"
    "        self.end_headers(); self.wfile.write(b'ok')\n"
    "    def log_message(self, *a): pass\n"
    "http.server.HTTPServer(('127.0.0.1', "
    "int(os.environ['SKYTPU_SERVE_REPLICA_PORT'])), H).serve_forever()\"")


def test_serve_vm_mode_end_to_end(serve_vm_mode):
    """The service controller and LB live on the dedicated controller
    cluster; this process runs no serve controller, yet the service
    comes up, answers through the controller host's endpoint, and tears
    down."""
    import urllib.request
    from skypilot_tpu_torch import serve as serve_lib
    from skypilot_tpu_torch.serve import controller as serve_ctl
    from skypilot_tpu_torch.serve.serve_state import ServiceStatus

    t = Task('vmsvc', run=_REPLICA_RUN, service={
        'readiness_probe': {'path': '/', 'initial_delay_seconds': 30},
        'replicas': 1})
    t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
    result = serve_lib.up(t)
    assert 'endpoint' in result
    assert not serve_ctl.live_controllers()
    # Waits poll the services table the controller host writes (this
    # machine's $HOME); the verb reads the settled status once.
    wait_for(lambda: _service_status('vmsvc') in (ServiceStatus.READY,),
             120, 'the service READY')
    records = serve_lib.status('vmsvc')
    assert records[0]['status'] is ServiceStatus.READY, records
    assert controller_daemon.daemon_alive()
    body = urllib.request.urlopen(result['endpoint'], timeout=10).read()
    assert body == b'ok'
    serve_lib.down('vmsvc')
    wait_for(lambda: _service_status('vmsvc') in (None,
                                                  ServiceStatus.SHUTDOWN),
             60, 'the service torn down')
    records = serve_lib.status('vmsvc')
    assert not records or records[0]['status'] is ServiceStatus.SHUTDOWN, (
        records)


def _service_status(name):
    from skypilot_tpu_torch.serve import serve_state
    rec = serve_state.get_service(name)
    return None if rec is None else rec['status']
