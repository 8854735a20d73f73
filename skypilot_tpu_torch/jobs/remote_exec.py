"""Managed-jobs verbs executed ON the dedicated controller cluster.

The client ships each verb as a short agent job on the controller
cluster (jobs/core.py dedicated mode); this module runs there, against
the CONTROLLER-LOCAL state DB, and prints one sentinel-prefixed JSON
line the client parses back out of the job logs — the same ship-codegen,
run-on-head, parse-stdout loop the reference uses for its jobs
controller (sky/jobs/server/core.py + codegen).

Every verb also ensures the persistent controller daemon
(controller_daemon.py) is running, detached, so controllers survive both
this short-lived process and any API-server restarts.

Usage (on the controller host):
  python -m skypilot_tpu_torch.jobs.remote_exec launch <base64(json)>
  python -m skypilot_tpu_torch.jobs.remote_exec queue
  python -m skypilot_tpu_torch.jobs.remote_exec cancel <job_id>
  python -m skypilot_tpu_torch.jobs.remote_exec logs <job_id> [offset]
  python -m skypilot_tpu_torch.jobs.remote_exec serve_up <base64(json)>
  python -m skypilot_tpu_torch.jobs.remote_exec serve_update <base64(json)>
  python -m skypilot_tpu_torch.jobs.remote_exec serve_down <name> [purge]
  python -m skypilot_tpu_torch.jobs.remote_exec serve_status [name]
(serve verbs live here too: both controller kinds share the transport
and, when co-hosted, the daemon.)
"""
from __future__ import annotations

import base64
import json
import os
import subprocess
import sys

SENTINEL = 'SKYTPU_REMOTE_RESULT:'


def ensure_daemon() -> None:
    from skypilot_tpu_torch.jobs import controller_daemon
    if controller_daemon.daemon_alive():
        return
    env = dict(os.environ)
    import skypilot_tpu_torch
    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.abspath(skypilot_tpu_torch.__file__)))
    env['PYTHONPATH'] = (pkg_parent + os.pathsep +
                         env.get('PYTHONPATH', '')).rstrip(os.pathsep)
    subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.jobs.controller_daemon'],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)


def _emit(payload) -> None:
    print(f'{SENTINEL}{json.dumps(payload, default=str)}', flush=True)


def main(argv) -> int:
    # The verbs below must act on THIS host's state DB, never recurse
    # through dedicated-mode routing; the persistent daemon (not this
    # short-lived process) drives the controllers.
    os.environ['SKYTPU_JOBS_LOCAL_MODE'] = '1'
    os.environ['SKYTPU_JOBS_NO_CONTROLLERS'] = '1'
    verb = argv[0]
    from skypilot_tpu_torch import dag as dag_lib
    from skypilot_tpu_torch import task as task_lib
    from skypilot_tpu_torch.jobs import core as jobs_core
    from skypilot_tpu_torch.jobs import state
    ensure_daemon()
    if verb == 'launch':
        spec = json.loads(base64.b64decode(argv[1]))
        tasks = [task_lib.Task.from_yaml_config(c)
                 for c in spec['tasks']]
        if len(tasks) == 1:
            job_id = jobs_core.launch(tasks[0], name=spec.get('name'))
        else:
            dag = dag_lib.Dag(name=spec.get('name'))
            prev = None
            for t in tasks:
                dag.add(t)
                if prev is not None:
                    dag.add_edge(prev, t)
                prev = t
            job_id = jobs_core.launch(dag, name=spec.get('name'))
        _emit({'job_id': job_id})
    elif verb == 'queue':
        all_users = len(argv) > 1 and argv[1] == '1'
        records = []
        for rec in jobs_core.queue(all_users=all_users):
            rec = dict(rec)
            status = rec.get('status')
            if hasattr(status, 'value'):
                rec['status'] = status.value
            records.append(rec)
        _emit({'jobs': records})
    elif verb == 'cancel':
        _emit({'cancelled': jobs_core.cancel(int(argv[1]))})
    elif verb == 'logs':
        rec = state.get(int(argv[1]))
        if rec is None:
            _emit({'error': 'not found'})
            return 1
        offset = int(argv[2]) if len(argv) > 2 else 0
        path = state.log_path(rec['job_id'])
        text = ''
        if os.path.exists(path):
            # Byte offsets (binary read): char counts drift on non-UTF8
            # bytes under errors='replace'.
            with open(path, 'rb') as f:
                f.seek(offset)
                raw = f.read()
            # A poll can catch the writer mid-character: hold back an
            # incomplete trailing UTF-8 sequence (it rides the next
            # poll) instead of permanently rendering it as U+FFFD.
            # Never hold back on a TERMINAL job (there is no next poll:
            # invalid trailing bytes must surface as U+FFFD, not vanish)
            # and never hold back bytes that cannot be a UTF-8 prefix
            # (>=4 trailing continuation bytes = just invalid data).
            if not rec['status'].is_terminal():
                trim = 0
                scanned = 0
                for scanned in range(1, min(4, len(raw)) + 1):
                    byte = raw[-scanned]
                    if byte < 0x80:
                        break
                    if byte >= 0xC0:      # lead byte of the sequence
                        need = (2 if byte < 0xE0 else
                                3 if byte < 0xF0 else 4)
                        if scanned < need:
                            trim = scanned
                        break
                if trim:
                    raw = raw[:-trim]
            text = raw.decode(errors='replace')
            offset += len(raw)
        _emit({'logs': text, 'offset': offset,
               'status': rec['status'].value})
    elif verb == 'serve_up':
        from skypilot_tpu_torch.serve import core as serve_core
        spec = json.loads(base64.b64decode(argv[1]))
        task = task_lib.Task.from_yaml_config(spec['task'])
        result = serve_core.up(task, service_name=spec.get('name'),
                               lb_port=spec.get('lb_port'))
        _emit({'name': result['name'],
               'port': int(result['endpoint'].rsplit(':', 1)[1])})
    elif verb == 'serve_update':
        from skypilot_tpu_torch.serve import core as serve_core
        spec = json.loads(base64.b64decode(argv[1]))
        task = task_lib.Task.from_yaml_config(spec['task'])
        result = serve_core.update(task, service_name=spec.get('name'))
        _emit({'name': spec.get('name'), 'version': result['version']})
    elif verb == 'serve_down':
        from skypilot_tpu_torch.serve import core as serve_core
        serve_core.down(argv[1], purge=len(argv) > 2 and argv[2] == '1')
        _emit({'down': argv[1]})
    elif verb == 'serve_status':
        from skypilot_tpu_torch.serve import core as serve_core
        names = [argv[1]] if len(argv) > 1 else None
        records = []
        for rec in serve_core.status(names):
            rec = dict(rec)
            rec['status'] = rec['status'].value
            rec['replicas'] = [dict(r, status=r['status'].value)
                               for r in rec['replicas']]
            records.append(rec)
        _emit({'services': records})
    else:
        _emit({'error': f'unknown verb {verb}'})
        return 2
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
