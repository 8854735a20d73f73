"""SkyServe of the port (`skypilot_tpu_torch.serve`): the cases of
tests/test_serve.py on its stub replica against the port's serve
controller, load balancer and replica manager; the pure modules
(service_spec, autoscalers, load_balancing_policies, slo_sim) held to
the JAX package's on the same specs and seeded traces (identical
decisions); and the port's load balancer in front of a port prefill
server and a port decode server at `tiny` on the CPU (the counterpart of
tests/test_serve_disagg.py::test_e2e_disagg_through_lb): ids equal to
monolithic serving, one KV export and one adopt.

Every wait has a deadline; the port's controller threads are stopped
after each case (`port_home`) and every process a case spawned is
killed at the module's end (`reap_marked`, tests/torch_control.py).
"""
import collections
import dataclasses
import random
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from skypilot_tpu.serve import autoscalers as jax_autoscalers
from skypilot_tpu.serve import load_balancing_policies as jax_policies
from skypilot_tpu.serve import service_spec as jax_spec
from skypilot_tpu.serve import slo_sim as jax_slo_sim
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import global_user_state
from skypilot_tpu_torch import serve
from skypilot_tpu_torch.resources import Resources
from skypilot_tpu_torch.serve import autoscalers
from skypilot_tpu_torch.serve import controller as controller_lib
from skypilot_tpu_torch.serve import load_balancing_policies as policies
from skypilot_tpu_torch.serve import serve_state
from skypilot_tpu_torch.serve import service_spec
from skypilot_tpu_torch.serve import slo_sim
from skypilot_tpu_torch.serve.serve_state import ReplicaStatus, ServiceStatus
from skypilot_tpu_torch.task import Task

from test_perf import _free_port, _get_json, _run_app_on_thread
from test_serve_trace import _post_json
from torch_control import port_home, reap_marked  # noqa: F401

# A tiny HTTP server that answers every GET with its replica id; binds the
# port the replica manager injects (tests/test_serve.py's).
_SERVER_RUN = '''python3 -c "
import http.server, os
rid = os.environ['SKYTPU_SERVE_REPLICA_ID']
class H(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        body = ('replica-' + rid).encode()
        self.send_response(200)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)
    def log_message(self, *a):
        pass
srv = http.server.ThreadingHTTPServer(
    ('127.0.0.1', int(os.environ['SKYTPU_SERVE_REPLICA_PORT'])), H)
srv.serve_forever()
"'''


@pytest.fixture
def serve_env(port_home, monkeypatch):
    monkeypatch.setenv('SKYTPU_SERVE_TICK_INTERVAL', '0.25')
    monkeypatch.setenv('SKYTPU_SERVE_QPS_WINDOW', '2')
    return port_home


def _service_task(name, service, run=_SERVER_RUN):
    t = Task(name, run=run, service=service)
    t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
    return t


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def _wait_ready_replicas(name, n, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        ready = [r for r in serve_state.get_replicas(name)
                 if r['status'] is ReplicaStatus.READY]
        if len(ready) >= n:
            return ready
        time.sleep(0.2)
    raise TimeoutError(
        f'{name}: never reached {n} READY replicas; at '
        f'{[(r["replica_id"], r["status"]) for r in serve_state.get_replicas(name)]}')


def _probe(**extra):
    return dict({'path': '/', 'initial_delay_seconds': 30,
                 'timeout_seconds': 2}, **extra)


# ----- the cases of tests/test_serve.py ---------------------------------------
def test_serve_up_load_balances_and_down(serve_env):
    task = _service_task('echo-svc', {
        'readiness_probe': _probe(), 'replicas': 2,
        'load_balancing_policy': 'round_robin'})
    endpoint = serve.up(task)['endpoint']
    try:
        controller_lib.wait_service_status(
            'echo-svc', (ServiceStatus.READY,), timeout_s=60)
        _wait_ready_replicas('echo-svc', 2)
        seen = collections.Counter()
        for _ in range(8):
            code, body = _get(endpoint + '/anything')
            assert code == 200
            seen[body] += 1
        assert len(seen) == 2, f'LB did not spread: {seen}'
    finally:
        serve.down('echo-svc')
    controller_lib.wait_service_status(
        'echo-svc', (ServiceStatus.SHUTDOWN,), timeout_s=60)
    for rec in serve_state.get_replicas('echo-svc', include_terminal=True):
        assert global_user_state.get_cluster(rec['cluster_name']) is None
    assert serve.status('echo-svc')[0]['status'] is ServiceStatus.SHUTDOWN


def test_serve_replica_preemption_replaced(serve_env):
    task = _service_task('prod-svc', {'readiness_probe': _probe(),
                                      'replicas': 2})
    serve.up(task)
    try:
        victim = _wait_ready_replicas('prod-svc', 2)[0]
        from skypilot_tpu_torch.provision.local import (
            instance as local_instance)
        local_instance.inject_preemption(victim['cluster_name'])
        deadline = time.time() + 60
        while time.time() < deadline:
            rec = serve_state.get_replica('prod-svc', victim['replica_id'])
            if rec['status'] is ReplicaStatus.PREEMPTED:
                break
            time.sleep(0.2)
        else:
            raise TimeoutError('preempted replica never marked PREEMPTED')
        new_ids = {r['replica_id']
                   for r in _wait_ready_replicas('prod-svc', 2)}
        assert victim['replica_id'] not in new_ids
        assert max(new_ids) > victim['replica_id']
    finally:
        serve.down('prod-svc')
    controller_lib.wait_service_status(
        'prod-svc', (ServiceStatus.SHUTDOWN,), timeout_s=60)


def test_serve_autoscales_under_load(serve_env):
    task = _service_task('scale-svc', {
        'readiness_probe': _probe(),
        'replica_policy': {
            'min_replicas': 1, 'max_replicas': 3,
            'target_qps_per_replica': 2.0,
            'upscale_delay_seconds': 0.5,
            'downscale_delay_seconds': 600}})
    endpoint = serve.up(task)['endpoint']
    try:
        _wait_ready_replicas('scale-svc', 1)
        # ~12 qps against a target of 2 a replica: desired hits the
        # max_replicas=3 clamp once the hysteresis elapses.
        deadline = time.time() + 30
        while time.time() < deadline:
            for _ in range(3):
                try:
                    _get(endpoint + '/load')
                except OSError:
                    pass
            live = serve_state.get_replicas('scale-svc')
            if len([r for r in live
                    if r['status'].counts_toward_target()]) >= 3:
                break
            time.sleep(0.25)
        else:
            raise TimeoutError('never scaled to 3')
        _wait_ready_replicas('scale-svc', 3)
    finally:
        serve.down('scale-svc')
    controller_lib.wait_service_status(
        'scale-svc', (ServiceStatus.SHUTDOWN,), timeout_s=60)


def test_serve_duplicate_name_rejected(serve_env):
    task = _service_task('dup-svc', {'readiness_probe': '/',
                                     'replicas': 1})
    serve.up(task)
    try:
        with pytest.raises(exceptions.ServeError):
            serve.up(task)
    finally:
        serve.down('dup-svc')
    controller_lib.wait_service_status(
        'dup-svc', (ServiceStatus.SHUTDOWN,), timeout_s=60)


def test_serve_requires_service_section(serve_env):
    t = Task('nosvc', run='echo hi')
    t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
    with pytest.raises(exceptions.InvalidTaskError):
        serve.up(t)


def test_serve_rolling_update(serve_env):
    """`serve update`: new-version replicas surge up, old ones drain only
    as replacements turn READY, the endpoint keeps answering throughout,
    and the service ends on the new version."""
    spec = {'readiness_probe': _probe(), 'replicas': 2}
    endpoint = serve.up(_service_task('roll-svc', spec))['endpoint']
    try:
        controller_lib.wait_service_status(
            'roll-svc', (ServiceStatus.READY,), timeout_s=90)
        _wait_ready_replicas('roll-svc', 2)
        v1_ids = {r['replica_id']
                  for r in serve_state.get_replicas('roll-svc')}
        assert all(r['version'] == 1
                   for r in serve_state.get_replicas('roll-svc'))
        run_v2 = _SERVER_RUN.replace("'replica-' + rid", "'v2-' + rid")
        assert serve.update(_service_task('roll-svc', spec,
                                          run=run_v2))['version'] == 2
        deadline = time.time() + 120
        while time.time() < deadline:
            live = serve_state.get_replicas('roll-svc')
            if live and len(live) >= 2 and all(
                    r['version'] == 2 and r['status'] is ReplicaStatus.READY
                    for r in live):
                break
            try:
                code, _ = _get(endpoint, timeout=3)
            except urllib.error.HTTPError as e:
                code = e.code
            except (urllib.error.URLError, ConnectionError, TimeoutError):
                code = None
            assert code in (None, 200), (
                f'endpoint unavailable mid-roll: HTTP {code}')
            time.sleep(0.3)
        live = serve_state.get_replicas('roll-svc')
        assert len(live) >= 2 and all(
            r['version'] == 2 and r['status'] is ReplicaStatus.READY
            for r in live), [(r['replica_id'], r['version'], r['status'])
                             for r in live]
        assert not (v1_ids & {r['replica_id'] for r in live})
        assert {_get(endpoint)[1].split('-')[0] for _ in range(6)} == {'v2'}
    finally:
        serve.down('roll-svc')
        controller_lib.wait_service_status(
            'roll-svc', (ServiceStatus.SHUTDOWN,), timeout_s=60)


def test_rollout_never_drains_below_target(serve_env, monkeypatch):
    """The drain budget is the READY surplus above target: with one
    replacement READY and one stuck STARTING, one old replica drains per
    tick, and the last only once the replacement is READY."""
    from skypilot_tpu_torch.serve.replica_managers import ReplicaManager
    serve_state.add_service('drainsvc', {
        'readiness_probe': {'path': '/'}, 'replicas': 2}, {}, 12345)
    spec = service_spec.ServiceSpec.from_yaml_config(
        {'readiness_probe': {'path': '/'}, 'replicas': 2})
    t = Task('drainsvc', run='x')
    t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
    mgr = ReplicaManager('drainsvc', spec, t, version=2)
    for rid, version, status in ((1, 1, ReplicaStatus.READY),
                                 (2, 1, ReplicaStatus.READY),
                                 (3, 2, ReplicaStatus.READY),
                                 (4, 2, ReplicaStatus.STARTING)):
        serve_state.add_replica('drainsvc', rid, f'c{rid}', version=version)
        serve_state.set_replica_status('drainsvc', rid, status)
    terminated = []
    monkeypatch.setattr(
        mgr, 'terminate_replica',
        lambda rid, preempted=False: (
            terminated.append(rid),
            serve_state.set_replica_status(
                'drainsvc', rid, ReplicaStatus.SHUTDOWN)))
    monkeypatch.setattr(mgr, 'scale_up',
                        lambda n: pytest.fail('no surge needed here'))
    assert mgr.rollout_step() is True
    assert terminated == [1]
    assert mgr.rollout_step() is True
    assert terminated == [1]
    serve_state.set_replica_status('drainsvc', 4, ReplicaStatus.READY)
    assert mgr.rollout_step() is True
    assert terminated == [1, 2]
    assert mgr.rollout_step() is False
    serve_state.remove_service('drainsvc')


# ----- the pure modules against the JAX package's -----------------------------
SPECS = [
    {'readiness_probe': '/health', 'replicas': 3},
    {'readiness_probe': {'path': '/v1/completions',
                         'post_data': {'prompt_ids': [1], 'max_tokens': 1},
                         'initial_delay_seconds': 60, 'timeout_seconds': 4},
     'replica_policy': {'min_replicas': 1, 'max_replicas': 5,
                        'target_qps_per_replica': 3.0,
                        'upscale_delay_seconds': 20,
                        'downscale_delay_seconds': 60},
     'load_balancing_policy': 'least_load'},
    {'readiness_probe': '/health',
     'replica_policy': {'min_replicas': 2, 'max_replicas': 6,
                        'target_qps_per_replica': 4.0,
                        'target_tpot_ms': 20.0,
                        'upscale_delay_seconds': 10,
                        'downscale_delay_seconds': 30}},
    {'readiness_probe': '/health', 'kv_page_size': 64,
     'replica_policy': {'min_replicas': 1, 'max_replicas': 8,
                        'target_qps_per_replica': 8.0,
                        'target_ttft_ms': 120.0, 'target_tpot_ms': 12.0,
                        'upscale_delay_seconds': 10,
                        'downscale_delay_seconds': 1200.0},
     'disaggregation': {'prefill_replicas': 2, 'decode_replicas': 1,
                        'use_spot_decode': True, 'spot_headroom': 1}},
    # Refused alike.
    {'replicas': 2},
    {'readiness_probe': '/health',
     'replica_policy': {'min_replicas': 3, 'max_replicas': 1}},
    {'readiness_probe': '/health', 'load_balancing_policy': 'fastest'},
]


def _spec_or_error(module, config):
    try:
        return module.ServiceSpec.from_yaml_config(config).to_yaml_config()
    except Exception as e:  # pylint: disable=broad-except
        return type(e).__name__, str(e)


@pytest.mark.parametrize('config', SPECS)
def test_service_spec_matches_jax(config):
    assert _spec_or_error(service_spec, config) == _spec_or_error(
        jax_spec, config)


def _decisions(spec_module, scaler_module, config, seed):
    """An autoscaler of `config` fed 40 ticks of a seeded request trace
    (timestamps and the LB's counter) and live counts; its decisions."""
    spec = spec_module.ServiceSpec.from_yaml_config(config)
    scaler = scaler_module.Autoscaler.make(spec, 5.0, 30.0)
    rng = random.Random(seed)
    now, stamps, total, live, out = 1000.0, [], 0, spec.min_replicas, []
    for _ in range(40):
        n = rng.randint(0, 60)
        stamps += sorted(now + 5.0 * rng.random() for _ in range(n))
        total += n
        now += 5.0
        d = scaler.evaluate(stamps, live, now)
        c = scaler.evaluate_counter(total, live, now)
        out.append((d.target_num_replicas, d.delta, c.target_num_replicas,
                    c.delta))
        live = max(0, live + rng.choice((-1, 0, 0, 1)))
    return out


@pytest.mark.parametrize('index', [0, 1, 2])
def test_autoscaler_decisions_match_jax(index):
    for seed in (0, 1, 2):
        assert _decisions(service_spec, autoscalers, SPECS[index], seed) == \
            _decisions(jax_spec, jax_autoscalers, SPECS[index], seed)


def test_slo_autoscalers_match_jax_through_slo_sim():
    """The canonical SLO and QPS ramps, the disaggregated per-pool ramp
    with a preemption, and the shared seeded RNG's draws."""
    for slo in (False, True):
        assert slo_sim.run_policy(slo, slo_sim.default_ramp()) == \
            jax_slo_sim.run_policy(slo, jax_slo_sim.default_ramp())
    for preempt in (None, 9):
        port = slo_sim.run_disagg_ramp(
            slo_sim.make_disagg_autoscaler(), slo_sim.make_disagg_service(),
            slo_sim.disagg_ramp(), preempt_tick=preempt)
        ref = jax_slo_sim.run_disagg_ramp(
            jax_slo_sim.make_disagg_autoscaler(),
            jax_slo_sim.make_disagg_service(), jax_slo_sim.disagg_ramp(),
            preempt_tick=preempt)
        assert port == ref
    assert [slo_sim.make_rng(7).random() for _ in range(3)] == [
        jax_slo_sim.make_rng(7).random() for _ in range(3)]
    hist = slo_sim.run_policy(True, slo_sim.default_ramp())
    assert slo_sim.requests_weighted_p95(hist, 6) == \
        jax_slo_sim.requests_weighted_p95(hist, 6)


@pytest.mark.parametrize('name', ['round_robin', 'least_load',
                                  'instance_aware'])
def test_load_balancing_policies_match_jax(name):
    """The same seeded trace of selections, request starts and ends (with
    durations), backlog reports and prunes into both packages' policy,
    step by step: the same replica chosen every time."""
    port, ref = policies.LoadBalancingPolicy.make(name), \
        jax_policies.LoadBalancingPolicy.make(name)
    urls = [f'http://10.0.0.{i}:8080' for i in range(4)]
    rng = random.Random(11)
    inflight = []
    for _ in range(300):
        op = rng.random()
        ready = [u for u in urls if rng.random() < 0.9] or urls[:1]
        if op < 0.5:
            a, b = port.select(ready), ref.select(ready)
            assert a == b
            port.on_request_start(a)
            ref.on_request_start(b)
            inflight.append(a)
        elif op < 0.8 and inflight:
            url = inflight.pop(rng.randrange(len(inflight)))
            duration = rng.uniform(0.01, 2.0)
            port.on_request_end(url, duration)
            ref.on_request_end(url, duration)
        elif op < 0.95:
            url, tokens = rng.choice(urls), rng.uniform(0, 4000)
            port.update_load(url, tokens)
            ref.update_load(url, tokens)
        else:
            port.prune(ready)
            ref.prune(ready)
        for url in urls:
            assert port.snapshot(url) == ref.snapshot(url)


# ----- the port's LB in front of port prefill and decode servers --------------
def test_disagg_through_the_ports_lb():
    """A completion POSTed to the port's LoadBalancer routes into the
    prefill pool, its KV pages push to the decode server, and the relayed
    ids equal the port's monolithic engine's; the LB's trace shows the
    admission and the route, the engines the export and the adopt."""
    from skypilot_tpu_torch.inference import engine as torch_engine
    from skypilot_tpu_torch.inference import server as torch_server
    from skypilot_tpu_torch.models import llama as tl
    from skypilot_tpu_torch.serve.load_balancer import LoadBalancer
    from skypilot_tpu_torch.server import metrics as metrics_lib
    from skypilot_tpu_torch.server import tracing

    cfg = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'], dtype=torch.float32)
    model = tl.Llama(cfg, tl.init_params(
        cfg, 'cpu', torch.Generator().manual_seed(0)))
    kw = dict(n_slots=2, prefill_buckets=(8, 16), steps_per_call=3,
              kv_page_size=8)

    def engine():
        return torch_engine.DecodeEngine(
            model, torch_engine.EngineConfig(**kw), device='cpu')

    prompt = np.random.default_rng(23).integers(
        1, cfg.vocab_size, 13).tolist()
    mono = engine()
    req = mono.submit(prompt, 8)
    while req.finished_at is None:
        mono.step()
    want = req.tokens()

    metrics_lib.reset_for_tests()
    tracing.reset_for_tests()
    pre, dec = engine(), engine()
    pre.start()
    dec.start()
    pre_port, stop_pre = _run_app_on_thread(
        torch_server.build_app(pre, role='prefill'))
    dec_port, stop_dec = _run_app_on_thread(
        torch_server.build_app(dec, role='decode'))
    pre_url = f'http://127.0.0.1:{pre_port}'
    dec_url = f'http://127.0.0.1:{dec_port}'
    lb = LoadBalancer(
        'disagg-svc', _free_port(), policies.LeastLoadPolicy(),
        ready_urls_fn=lambda: [pre_url, dec_url],
        ready_replicas_fn=lambda: [(1, pre_url, 'prefill'),
                                   (2, dec_url, 'decode')])
    lb.start()
    try:
        rid = 'port-disagg-1'
        status, headers, body = _post_json(
            lb.endpoint + '/v1/completions',
            {'prompt_ids': prompt, 'max_tokens': 8},
            headers={tracing.TRACE_HEADER: rid})
        assert status == 200
        assert body['ids'] == want
        assert body['disaggregated'] is True
        assert body['decode_url'] == dec_url
        assert headers[tracing.TRACE_HEADER] == rid
        out = metrics_lib.render()
        assert 'skytpu_engine_kv_exports_total 1.0' in out
        assert 'skytpu_engine_kv_adopts_total 1.0' in out
        assert 'skytpu_lb_kv_transfer_total{outcome="ok"} 1.0' in out
        _, doc = _get_json(lb.endpoint + f'/debug/requests/{rid}')
        names = [e['name'] for e in doc['events']]
        for needle in ('lb.admission', 'lb.route', 'engine.kv_export',
                       'engine.kv_adopt', 'engine.first_token'):
            assert needle in names, (needle, names)
    finally:
        lb.stop()
        stop_pre()
        stop_dec()
        pre.stop()
        dec.stop()
        metrics_lib.reset_for_tests()
