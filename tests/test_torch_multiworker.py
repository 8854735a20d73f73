"""The port's multi-worker API server: N `python -m
skypilot_tpu_torch.server.app` processes share one port (SO_REUSEPORT)
and the requests DB as the queue.  The sqlite cases of
tests/test_multiworker.py: the claim CAS, two workers recovering the
same PENDING rows (each runs exactly once: three local launches) and a
drain posted to one worker gating every worker (the same 2-worker
server, booted once for the module over the staged rows).  Its lease-takeover case
is in tests/test_torch_server_daemons.py; the Postgres params of the
JAX file need SKYTPU_TEST_PG_URL and are not ported (ROADMAP)."""
import os
import time

import pytest
import requests as requests_lib

from skypilot_tpu_torch.parallel.group import free_port
from skypilot_tpu_torch.server import requests_db

from test_torch_server_daemons import server_env, start_server, stop_server
from torch_control import port_home, reap_marked, wait_for  # noqa: F401


@pytest.fixture(scope='module')
def mw_server(tmp_path_factory):
    """Three PENDING launch rows staged in a fresh requests DB, then a
    2-worker server booted over it (both workers run startup recovery
    over the same rows); stopped at the module's end."""
    tmp = tmp_path_factory.mktemp('torch-mw')
    home = tmp / 'home'
    home.mkdir()
    pid_file = tmp / 'agent-pids.txt'
    pid_file.touch()
    env = server_env(home, pid_file)
    env['SKYTPU_REQUESTS_DB'] = os.path.join(str(home), '.skytpu',
                                             'requests.db')
    markers, rids = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('HOME', env['HOME'])
        mp.delenv('SKYTPU_DB_URL', raising=False)
        mp.setenv('SKYTPU_REQUESTS_DB', env['SKYTPU_REQUESTS_DB'])
        for i in range(3):
            marker = tmp / f'ran-{i}.txt'
            markers.append(marker)
            rids.append(requests_db.create('launch', {
                'task': {'name': f'mw{i}',
                         'run': f'echo ran >> {marker}',
                         'resources': {'infra': 'local'}},
                'cluster_name': f'mwc{i}',
            }))
    port = free_port()
    proc = start_server(port, env, workers=2)
    try:
        yield {'port': port, 'rids': rids, 'markers': markers}
    finally:
        stop_server(proc)


def test_try_claim_cas(port_home):
    """Exactly one claimer wins; a live claimer's row is not stealable,
    a dead claimer's row is."""
    rid = requests_db.create('launch', {'x': 1})
    me = os.getpid()
    assert requests_db.try_claim(rid, me)
    # Another live process (pid 1) cannot steal from a live claimer.
    assert not requests_db.try_claim(rid, 1)
    # A dead claimer's row IS stealable.
    from skypilot_tpu_torch.utils import db_utils
    rid2 = requests_db.create('launch', {'x': 2})
    dead = 2 ** 22 + 12345   # beyond default pid_max
    db_utils.execute(
        requests_db._ensure(),  # pylint: disable=protected-access
        'UPDATE requests SET claim_pid=? WHERE request_id=?',
        (dead, rid2))
    assert requests_db.try_claim(rid2, me)
    # A terminal/claimed-and-running row is never claimable once it
    # leaves PENDING.
    requests_db.set_status(rid, requests_db.RequestStatus.SUCCEEDED)
    assert not requests_db.try_claim(rid, me)


def test_two_workers_recover_pending_rows_once(mw_server):
    """PENDING launch rows staged in the durable queue before a 2-worker
    server booted: both workers ran recovery concurrently, and each row
    executed EXACTLY once."""
    port, rids, markers = (mw_server['port'], mw_server['rids'],
                           mw_server['markers'])

    def statuses():
        recs = {r['request_id']: r for r in requests_lib.get(
            f'http://127.0.0.1:{port}/requests', timeout=10).json()}
        sts = [recs.get(rid, {}).get('status') for rid in rids]
        return sts if all(s in ('SUCCEEDED', 'FAILED') for s in sts) \
            else None
    sts = wait_for(statuses, 180, 'the recovered requests', 0.5)
    assert all(s == 'SUCCEEDED' for s in sts), sts
    # The launch request succeeds at job submission; the agent runs the
    # job moments later — wait for every marker, then give a would-be
    # duplicate execution time to land before counting.
    wait_for(lambda: all(m.exists() for m in markers), 60,
             'every staged job')
    time.sleep(3)
    for marker in markers:
        lines = marker.read_text().splitlines()
        assert lines == ['ran'], (
            f'{marker}: executed {len(lines)} times (want exactly 1)')


def test_drain_gates_every_worker(mw_server):
    """POST /api/drain lands on ONE worker; every worker must then 503
    new mutations (shared flag in the requests DB)."""
    port = mw_server['port']
    r = requests_lib.post(f'http://127.0.0.1:{port}/api/drain',
                          timeout=10)
    assert r.ok
    # Drain reaches sibling workers through the shared DB flag,
    # TTL-cached (_is_draining): wait out the propagation window.
    from skypilot_tpu_torch.server import app as app_lib
    time.sleep(app_lib._DRAIN_FLAG_TTL_S + 0.5)  # pylint: disable=protected-access
    # Many attempts so the kernel's SO_REUSEPORT hashing spreads
    # them over both workers: every single one must be refused.
    for _ in range(10):
        r = requests_lib.post(
            f'http://127.0.0.1:{port}/launch',
            json={'task': {'name': 'nope', 'run': 'echo no',
                           'resources': {'infra': 'local'}},
                  'cluster_name': 'nopec'},
            timeout=10)
        assert r.status_code == 503, r.text
    assert requests_lib.get(f'http://127.0.0.1:{port}/requests',
                            timeout=10).ok
    assert requests_lib.get(f'http://127.0.0.1:{port}/api/health',
                            timeout=10).json()['status'] == 'draining'

