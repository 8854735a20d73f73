"""The SSH cloud of the port against the JAX package's: node pools (pool
file, allocation, liveness, the cloud layer), the gang over the SSH
runner driven directly through a loopback `ssh` shim, and the framework
key (generation and rotation), each scenario run through both packages
under HOMEs of their own and compared exactly (mirrors
tests/test_ssh_node_pools.py, tests/test_ssh_gang.py and
tests/test_authentication.py).  No case here starts an agent: the
backend's remote bootstrap runs `pkill -f` on the host, which on a
loopback host would reach other tests' agents."""
import json
import os
import pathlib
import socket
import threading
import time

import pytest

import chip_smoke
from tests.torch_parity import outcome, run_both, shim, statuses

@pytest.fixture
def tcp_listener():
    """A live TCP port standing in for sshd."""
    srv = socket.socket()
    srv.bind(('0.0.0.0', 0))     # reachable via any 127.0.0.x alias
    srv.listen(16)
    port = srv.getsockname()[1]

    def accept_loop():
        while True:
            try:
                conn, _ = srv.accept()
                conn.close()
            except OSError:
                return

    threading.Thread(target=accept_loop, daemon=True).start()
    yield port
    srv.close()


@pytest.fixture
def ssh_shim(tmp_path, monkeypatch):
    """The smoke's loopback `ssh` first on PATH: it runs the remote
    command here and logs each argv (JSON) to SMOKE_SSH_LOG."""
    shim(tmp_path / 'shim', 'ssh', chip_smoke.SSH_SHIM)
    monkeypatch.setenv('PATH',
                       f'{tmp_path / "shim"}{os.pathsep}{os.environ["PATH"]}')
    monkeypatch.setenv('SMOKE_SSH_LOG', str(tmp_path / 'ssh.log'))
    return tmp_path


def _targets(log):
    """The user@host each logged ssh call was pointed at."""
    return [a for line in log.read_text().splitlines()
            for a in json.loads(line) if '@' in a]


def _write_pools(home, port):
    path = home / '.skytpu' / 'ssh_node_pools.yaml'
    path.parent.mkdir(exist_ok=True)
    path.write_text(f'''
lab:
  user: ubuntu
  port: {port}
  hosts: [127.0.0.1, 127.0.0.2, 127.0.0.3]
small:
  port: 1
  hosts: [127.0.0.9]
''')


def _config(pkg, cluster, pool_name='lab', num_nodes=1):
    return pkg('provision.common').ProvisionConfig(
        cluster_name=cluster, num_nodes=num_nodes,
        resources_config={'cpus': '2', 'infra': f'ssh/{pool_name}'},
        region=pool_name)


def _both(scenario, tmp_path, monkeypatch):
    jax_side, port_side = run_both(scenario, tmp_path, monkeypatch)
    assert port_side == jax_side
    return port_side


def test_pool_allocation_lifecycle(tmp_path, monkeypatch, tcp_listener):
    def scenario(pkg):
        _write_pools(pathlib.Path(os.environ['HOME']), tcp_listener)
        pools = pkg('ssh_node_pools')
        provision = pkg('provision')
        out = {'pools': pools.load_pools(), 'usage': pools.pool_usage()}
        record = provision.run_instances('ssh', _config(pkg, 'c1',
                                                        num_nodes=2))
        provision.wait_instances('ssh', 'c1', region='lab')
        info = provision.get_cluster_info('ssh', 'c1', region='lab')
        out['c1'] = (record.instance_ids, record.resumed,
                     statuses(provision.query_instances('ssh', 'c1',
                                                        region='lab')),
                     info.ssh_user, info.node_ips)
        again = provision.run_instances('ssh', _config(pkg, 'c1',
                                                       num_nodes=2))
        out['again'] = (again.resumed, again.instance_ids)
        provision.run_instances('ssh', _config(pkg, 'c2'))
        out['full'] = outcome(provision.run_instances, 'ssh',
                              _config(pkg, 'c3'))
        provision.terminate_instances('ssh', 'c1', region='lab')
        out['c3'] = provision.run_instances(
            'ssh', _config(pkg, 'c3', num_nodes=2)).instance_ids
        out['usage_after'] = pools.pool_usage('lab')
        provision.run_instances('ssh', _config(pkg, 'cd',
                                               pool_name='small'))
        out['dead'] = statuses(provision.query_instances('ssh', 'cd',
                                                         region='small'))
        out['dead_wait'] = outcome(provision.wait_instances, 'ssh', 'cd',
                                   region='small')
        out['released'] = pools.allocation('small', 'cd')
        out['unknown'] = outcome(provision.run_instances, 'ssh',
                                 _config(pkg, 'cx', pool_name='nope'))
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['c1'][0] == ['127.0.0.1', '127.0.0.2']
    assert out['c1'][3:] == ('ubuntu', [['127.0.0.1'], ['127.0.0.2']])
    assert out['again'] == (True, ['127.0.0.1', '127.0.0.2'])
    assert out['full'] == ('raise', 'InsufficientCapacityError')
    assert out['usage_after'][0]['clusters'] == ['c2', 'c3']
    assert out['dead'] == {'127.0.0.9': 'TERMINATED'}
    assert out['dead_wait'] == ('raise', 'InsufficientCapacityError')
    assert out['released'] == []
    assert out['unknown'] == ('raise', 'InvalidInfraError')


def test_cloud_layer_places_a_gpu_task_on_a_pool(tmp_path, monkeypatch,
                                                 tcp_listener):
    """The pools are the cloud's regions; an unpinned request and a TPU
    are not placed there; `H100:1` pinned to a pool is, and the
    optimizer picks it (the placement of the smoke's ssh_pool phase)."""
    monkeypatch.setenv('SKYTPU_ENABLED_CLOUDS', 'ssh,local')

    def scenario(pkg):
        _write_pools(pathlib.Path(os.environ['HOME']), tcp_listener)
        cloud = pkg('clouds').get_cloud('ssh')
        res_cls = pkg('resources').Resources

        def regions(spec):
            return sorted(f.region for f in cloud.get_feasible_resources(
                res_cls.from_yaml_config(spec)))

        task = pkg('task').Task('job', run='echo hi')
        task.set_resources(res_cls.from_yaml_config(
            {'infra': 'ssh/lab', 'accelerators': 'H100:1'}))
        routed = pkg('optimizer').fill_in_launchable_resources(task, None)
        return (cloud.check_credentials()[0],
                regions({'infra': 'ssh', 'cpus': '2'}),
                regions({'infra': 'ssh/lab'}), regions({'cpus': '2'}),
                regions({'infra': 'ssh', 'accelerators': 'tpu-v5p-8'}),
                [(c.cloud, c.region, str(c.accelerators))
                 for c in next(iter(routed.values()))])

    out = _both(scenario, tmp_path, monkeypatch)
    assert out[:5] == (True, ['lab', 'small'], ['lab'], [], [])
    assert out[5] == [('ssh', 'lab', "{'H100': 1}")]


def _gang_spec(run, nodes):
    return {'run': run, 'nodes': nodes, 'chips_per_host': 4,
            'is_local': False, 'ssh_user': 'skytpu', 'ssh_key_path': None,
            'envs': {}}


def test_gang_over_ssh(tmp_path, monkeypatch, ssh_shim):
    """Two ranks over the SSH runner: the env contract each sees, the
    hosts the client was pointed at, the per-rank logs; a failing rank
    kills its peer fast; a cancel tears both down."""
    def scenario(pkg):
        gang = pkg('agent.gang')
        job_queue = pkg('agent.job_queue')
        root = tmp_path / pkg.name
        out_dir = root / 'rank-out'
        out_dir.mkdir()
        targets = root / 'ssh.log'
        monkeypatch.setenv('SMOKE_SSH_LOG', str(targets))
        nodes = [['127.0.0.2'], ['127.0.0.3']]
        out = {}
        run = ('echo "rank=$SKYTPU_NODE_RANK nodes=$SKYTPU_NUM_NODES '
               'coord=$SKYTPU_COORDINATOR_ADDR chips=$SKYTPU_NUM_TPU_CHIPS '
               'ips=$SKYTPU_NODE_IPS" > '
               f'{out_dir}/rank-$SKYTPU_NODE_RANK.txt')
        seen = []
        rc = gang.run_gang_job(1, _gang_spec(run, nodes),
                               str(root / 'logs1'),
                               lambda s, r: seen.append((s.value, r)))
        out['env'] = (rc, seen, sorted(
            (p.name, p.read_text()) for p in out_dir.iterdir()),
            sorted(_targets(targets)),
            sorted(p.name for p in (root / 'logs1').iterdir()))
        marker = root / 'survivor-finished'
        run = ('if [ "$SKYTPU_NODE_RANK" = "0" ]; then exit 3; '
               f'else sleep 120 && touch {marker}; fi')
        seen = []
        t0 = time.time()
        rc = gang.run_gang_job(2, _gang_spec(run, nodes),
                               str(root / 'logs2'),
                               lambda s, r: seen.append((s.value, r)))
        out['fail'] = (rc, seen[-1], time.time() - t0 < 30,
                       marker.exists())
        marker = root / 'ran-to-completion'
        job = gang.GangJob(3, _gang_spec(f'sleep 120 && touch {marker}',
                                         nodes), str(root / 'logs3'))
        seen = []
        th = threading.Thread(target=gang.run_gang_job, args=(
            3, job.spec, str(root / 'logs3'),
            lambda s, r: seen.append((s.value, r)), job))
        th.start()
        time.sleep(1.0)
        job.cancel()
        th.join(timeout=30)
        out['cancel'] = (th.is_alive(), seen[-1][0], marker.exists(),
                         job_queue.JobStatus.CANCELLED.value)
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    rc, seen, ranks, targets, logs = out['env']
    assert rc == 0 and seen[-1] == ('SUCCEEDED', 0)
    assert 'rank=0 nodes=2 coord=127.0.0.2:' in ranks[0][1]
    assert 'chips=4' in ranks[1][1]
    assert targets == ['skytpu@127.0.0.2', 'skytpu@127.0.0.3']
    assert logs == ['run-0.log', 'run-1.log']
    assert out['fail'] == (3, ('FAILED', 3), True, False)
    assert out['cancel'] == (False, 'CANCELLED', False, 'CANCELLED')


def test_keys_generated_once_and_rotated_over_ssh(tmp_path, monkeypatch,
                                                  ssh_shim):
    """The framework key pair, and a rotation that pushes the new key to
    an UP cluster's host through the SSH runner, skips a BYO-keyed
    cluster, backs the old pair up, and aborts with nothing changed when
    a framework-keyed cluster is STOPPED."""
    def scenario(pkg):
        auth = pkg('authentication')
        state = pkg('global_user_state')
        handle_cls = state.ClusterHandle
        status = state.ClusterStatus
        out = {}
        priv, pub = auth.get_or_generate_keys()
        out['generate'] = (priv == os.path.expanduser(auth.PRIVATE_KEY_PATH),
                           auth.get_or_generate_keys() == (priv, pub),
                           pub.split()[0], oct(os.stat(priv).st_mode & 0o777))
        state.add_or_update_cluster('rotc', handle_cls(
            'rotc', 'gcp', 'us-east5', 'us-east5-a',
            {'accelerators': 'tpu-v5e-8'}, 1, [['127.0.0.1']], ['rotc-0'],
            ssh_user=os.environ.get('USER', 'root'), ssh_key_path=priv),
            status.UP)
        state.add_or_update_cluster('byo', handle_cls(
            'byo', 'ssh', 'pool', 'pool', {'infra': 'ssh'}, 1,
            [['127.0.0.1']], ['byo-0'], ssh_user='x',
            ssh_key_path='/somewhere/else/id'), status.UP)
        result = auth.rotate_keys()
        _, new_pub = auth.get_or_generate_keys()
        keys = os.path.expanduser('~/.ssh/authorized_keys')
        auth.rotate_keys()
        out['rotate'] = (result, new_pub != pub,
                         open(keys, encoding='utf-8').read().count(new_pub),
                         # Each rotation backs the old pair up under a
                         # stamp of its second: two rotations in one
                         # second leave one pair.
                         any(f.startswith('sky-key.pub.') and
                             f.endswith('.bak') for f in os.listdir(
                             os.path.dirname(priv))))
        state.add_or_update_cluster('stpd', handle_cls(
            'stpd', 'aws', 'us-east-1', None, {'instance_type': 'm6i.large'},
            1, [['10.0.0.9']], ['stpd-0'], ssh_user='skytpu',
            ssh_key_path=priv), status.STOPPED)
        _, before = auth.get_or_generate_keys()
        aborted = outcome(auth.rotate_keys)
        out['abort'] = (aborted, auth.get_or_generate_keys()[1] == before,
                        os.path.exists(priv + '.rotating'))
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['generate'] == (True, True, 'ssh-ed25519', '0o600')
    result, changed, count, backed_up = out['rotate']
    assert result['rotated'] == ['rotc'] and changed and count == 1
    assert result['skipped'][0].startswith('byo:') and backed_up
    assert out['abort'] == (('raise', 'SkyTpuError'), True, False)


def test_bootstrap_pkill_spares_its_own_shell():
    """The remote bootstrap stops a running agent with `pkill -f` before it
    starts one.  The JAX backend's pattern (its module's name) also
    matches the shell that runs the bootstrap, whose command line holds
    that name, so pkill ends the bootstrap before it starts the agent;
    the port's pattern matches the agent's own command line only.  Read
    with `pgrep` (nothing is signalled: a pkill here would reach other
    tests' agents)."""
    import inspect
    import re
    import shlex
    import subprocess

    from skypilot_tpu.backends import tpu_vm_backend as jax_backend
    from skypilot_tpu_torch.backends import tpu_vm_backend as port_backend

    def matches_own_shell(pattern):
        out = subprocess.run(
            ['bash', '-c', f'pgrep -f {shlex.quote(pattern)}; '
                           'echo "self=$$"; true'],
            capture_output=True, text=True, timeout=30).stdout.split()
        return out[-1].split('=')[1] in out[:-1]

    assert 'pkill -f skypilot_tpu.agent.server' in inspect.getsource(
        jax_backend)
    assert matches_own_shell('skypilot_tpu.agent.server')
    pattern = port_backend.AGENT_PKILL_PATTERN
    assert not matches_own_shell(pattern)
    assert f'pkill -f {{shlex.quote(AGENT_PKILL_PATTERN)}}' in (
        inspect.getsource(port_backend))
    for cmdline, agent in (
            ('python3 -m skypilot_tpu_torch.agent.server --port 8790', True),
            ('/opt/venv/bin/python -m skypilot_tpu_torch.agent.server',
             True),
            ('bash -c pkill -f x; cd ~/skytpu_runtime && nohup python3 -m '
             'skypilot_tpu_torch.agent.server --port 8790', False),
            ('python3 -m skypilot_tpu.agent.server --port 8790', False)):
        assert bool(re.search(pattern, cmdline)) is agent, cmdline


def test_agent_client_waits_for_its_ssh_tunnel(tmp_path, monkeypatch,
                                               ssh_shim):
    """The port's agent client reaches an agent on a remote host through
    `ssh -N -L` and waits for the forward to listen before its first
    request (the JAX client sends it at once and can find the local port
    still closed).  The `ssh` here is the smoke's loopback shim, which
    makes -L a real TCP forward; a tunnel that exits is an unreachable
    head, not a hang."""
    import http.server
    import json

    from skypilot_tpu_torch import exceptions
    from skypilot_tpu_torch.agent import client as client_lib

    class Health(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # pylint: disable=invalid-name
            body = json.dumps({'ok': True, 'path': self.path}).encode()
            self.send_response(200)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    agent = http.server.ThreadingHTTPServer(('127.0.0.1', 0), Health)
    threading.Thread(target=agent.serve_forever, daemon=True).start()
    try:
        client = client_lib.AgentClient('127.0.0.2', 'skytpu', None,
                                        agent.server_address[1])
        tunnel = client._tunnel_proc  # pylint: disable=protected-access
        try:
            assert client.health() == {'ok': True, 'path': '/health'}
        finally:
            client.close()
        tunnel.wait(timeout=10)
        assert '-L' in (tmp_path / 'ssh.log').read_text()
        shim(tmp_path / 'shim', 'ssh', '#!/usr/bin/env bash\nexit 255\n')
        t0 = time.monotonic()
        with pytest.raises(exceptions.HeadNodeUnreachableError,
                           match='ssh exit 255'):
            client_lib.AgentClient('127.0.0.2', 'skytpu', None,
                                   agent.server_address[1])
        assert time.monotonic() - t0 < 10
    finally:
        agent.shutdown()
        agent.server_close()
