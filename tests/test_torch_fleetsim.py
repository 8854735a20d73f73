"""The port's fleet simulator and goodput sim (`skypilot_tpu_torch/
fleetsim/`, copies of the JAX package's modules) held against the JAX
package on the same seeds, in one process.

- Traffic and scenarios: the JAX suite's statistical cases on the port's
  generator, and identical arrival lists and scenarios from both.
- The smoke fleet, run once per package on a sqlite file of its own
  (`run_fleet` sets the shared `SKYTPU_*` variables for the run, so each
  run gets its own DSN and the environment must come back as it was):
  equal results without the host-timed `profile` and `wall_s`, the real
  control stack driven (counted, not replaced), replica rows and the
  lease takeover in each run's own file, the profile ranking `db.*` and
  `fleetsim.*` paths from the port's own registry.
- The canonical fleet through both packages (the README's headline), and
  `chip_smoke.py`'s reference constants held against the JAX run.
- The goodput sim's planted straggler and healthy run: equal dicts.
- `python -m skypilot_tpu_torch.fleetsim --smoke --json` in a subprocess
  against the JAX CLI, importing neither torch nor JAX.
"""
import collections
import dataclasses
import importlib
import os
import sqlite3
import subprocess
import sys

import pytest

import chip_smoke
from pg_utils import needs_pg, pg_schema

PACKAGES = ('skypilot_tpu', 'skypilot_tpu_torch')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ('SKYTPU_SERVE_DB', 'SKYTPU_DB_URL', 'SKYTPU_DB_LEASES',
            'SKYTPU_LEASE_TTL_S')


def lib(pkg, module):
    return importlib.import_module(f'{pkg}.{module}')


def comparable(result) -> dict:
    """A FleetResult as a dict without what the host clock measured."""
    out = result.to_dict(with_history=True)
    del out['profile'], out['wall_s']
    return out


# ---------------------------------------------------------------------------
# Traffic generator and scenarios
# ---------------------------------------------------------------------------
def _spec(pkg, **kw):
    base = dict(base_qps=50.0, diurnal_amplitude=0.0,
                diurnal_period_s=100.0, mean_turns=1.0,
                mean_think_s=5.0, users=1_000_000)
    base.update(kw)
    return lib(pkg, 'fleetsim.traffic').TrafficSpec(**base)


def _arrivals(seed, horizon_s, **kw):
    """Both packages' arrivals for one spec and seed; asserts they are
    equal and returns the port's."""
    out = {}
    for pkg in PACKAGES:
        gen = lib(pkg, 'fleetsim.traffic').TrafficGenerator(
            _spec(pkg, **kw), lib(pkg, 'serve.slo_sim').make_rng(seed))
        out[pkg] = gen.generate(horizon_s)
    assert ([dataclasses.astuple(r) for r in out['skypilot_tpu_torch']] ==
            [dataclasses.astuple(r) for r in out['skypilot_tpu']])
    return out['skypilot_tpu_torch']


def test_traffic_poisson_rate_matches_envelope():
    reqs = _arrivals(1, 200.0)
    assert abs(len(reqs) - 10_000) < 500
    assert all(0.0 <= r.t < 200.0 for r in reqs)
    assert [r.t for r in reqs] == sorted(r.t for r in reqs)


def test_traffic_diurnal_envelope_shapes_arrivals():
    reqs = _arrivals(2, 400.0, diurnal_amplitude=0.6)
    assert abs(len(reqs) - 20_000) < 1_000
    rising = sum(1 for r in reqs if (r.t % 100.0) < 50.0)
    assert rising > 1.4 * (len(reqs) - rising)


def test_traffic_burst_multiplier_window():
    reqs = _arrivals(3, 150.0, bursts=((100.0, 50.0, 3.0),))
    quiet = sum(1 for r in reqs if r.t < 50.0)
    burst = sum(1 for r in reqs if 100.0 <= r.t < 150.0)
    assert burst > 2.0 * quiet


def test_traffic_sessions_accumulate_prefix():
    kw = dict(mean_turns=4.0, shared_prefix_tokens=300.0,
              turn_history_tokens=100.0)
    reqs = _arrivals(4, 300.0, **kw)
    by_turn = collections.Counter(r.turn for r in reqs)
    assert by_turn[1] > by_turn[2] > by_turn[4] > 0
    first_seen = {}
    for r in reqs:
        assert r.prefix_tokens == (kw['shared_prefix_tokens'] +
                                   (r.turn - 1) * kw['turn_history_tokens'])
        assert r.prompt_tokens >= 16.0 and r.new_tokens >= 8.0
        assert r.t >= first_seen.setdefault(r.session_id, r.t)


def test_traffic_deterministic_under_seed():
    pkg = 'skypilot_tpu_torch'
    traffic, slo_sim = lib(pkg, 'fleetsim.traffic'), lib(pkg, 'serve.slo_sim')
    spec = _spec(pkg, mean_turns=3.0)
    a, b, c = (traffic.TrafficGenerator(spec, slo_sim.make_rng(s))
               for s in (7, 7, 8))
    assert a.generate(60.0) == b.generate(60.0)
    assert a.generate(60.0) != c.generate(60.0)


def _events(scenario):
    return [(type(e).__name__, dataclasses.asdict(e))
            for e in scenario.events]


def test_scenario_events_fire_exactly_once():
    fired = {}
    for pkg in PACKAGES:
        sc_lib = lib(pkg, 'fleetsim.scenario')
        sc = sc_lib.Scenario([sc_lib.PreemptionStorm(at_s=5.0, fraction=0.5),
                              sc_lib.LeaseholderKill(at_s=5.5),
                              sc_lib.LBSever(at_s=9.0, duration_s=3.0)])
        fired[pkg] = [[e.kind for e in sc.due(t0, t1)] for t0, t1 in (
            (0.0, 5.0), (5.0, 6.0), (5.0, 6.0), (9.0, 10.0))]
    assert fired['skypilot_tpu_torch'] == fired['skypilot_tpu']
    quiet, first, again, sever = fired['skypilot_tpu_torch']
    assert quiet == [] and again == [] and sever == ['lb_sever']
    assert set(first) == {'preemption_storm', 'leaseholder_kill'}


def test_scenario_from_config_and_yaml(tmp_path):
    path = tmp_path / 'storm.yaml'
    path.write_text(
        'events:\n'
        '  - {kind: preemption_storm, at_s: 20, fraction: 0.25,\n'
        '     pool: prefill}\n'
        '  - {kind: lb_sever, at_s: 40, duration_s: 5, lb: 2}\n'
        'bursts:\n'
        '  - {at_s: 10, duration_s: 5, multiplier: 2.0}\n')
    loaded = {pkg: lib(pkg, 'fleetsim.scenario').Scenario.load(str(path))
              for pkg in PACKAGES}
    sc = loaded['skypilot_tpu_torch']
    storm, sever = sc.events
    assert (storm.fraction, storm.pool) == (0.25, 'prefill')
    assert (sever.duration_s, sever.lb_index) == (5.0, 2)
    assert sc.bursts == ((10.0, 5.0, 2.0),)
    assert _events(sc) == _events(loaded['skypilot_tpu'])
    assert sc.bursts == loaded['skypilot_tpu'].bursts
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match='unknown scenario event'):
            lib(pkg, 'fleetsim.scenario').Scenario.from_config(
                {'events': [{'kind': 'meteor', 'at_s': 1}]})


def test_scenario_canonical_matches_published_constants():
    canon = {pkg: lib(pkg, 'fleetsim.scenario').Scenario.canonical()
             for pkg in PACKAGES}
    sc, slo_sim = canon['skypilot_tpu_torch'], lib('skypilot_tpu_torch',
                                                   'serve.slo_sim')
    storm = next(e for e in sc.events if type(e).__name__ ==
                 'PreemptionStorm')
    assert storm.at_s == slo_sim.FLEET_STORM_AT_S
    assert storm.fraction == slo_sim.FLEET_STORM_FRACTION
    assert sc.bursts == ((slo_sim.FLEET_BURST_AT_S,
                          slo_sim.FLEET_BURST_DURATION_S,
                          slo_sim.FLEET_BURST_MULTIPLIER),)
    assert _events(sc) == _events(canon['skypilot_tpu'])
    assert sc.bursts == canon['skypilot_tpu'].bursts


# ---------------------------------------------------------------------------
# The smoke fleet, once per package
# ---------------------------------------------------------------------------
def _counted_run(pkg, config):
    """run_fleet of `pkg` with call counters wrapped (not replaced) around
    the control-plane entry points the simulator claims to drive, and the
    shared SKYTPU_* variables read before and after."""
    autoscalers = lib(pkg, 'serve.autoscalers')
    load_balancer = lib(pkg, 'serve.load_balancer')
    policies = lib(pkg, 'serve.load_balancing_policies')
    leases = lib(pkg, 'state.leases')
    counts = collections.Counter()
    mp = pytest.MonkeyPatch()

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for owner, attr, name in (
            (autoscalers.DisaggSLOAutoscaler, 'evaluate_pools',
             'evaluate_pools'),
            (leases, 'try_acquire_singleton', 'try_acquire_singleton'),
            (policies.RoundRobinPolicy, 'select', 'policy_select'),
            (load_balancer.LoadBalancer, '_pick_decode_targets',
             'pick_decode_targets'),
            (load_balancer.LoadBalancer, '_shed_excess_tokens',
             'shed_excess_tokens')):
        mp.setattr(owner, attr, counted(name, getattr(owner, attr)))
    env_before = {k: os.environ.get(k) for k in ENV_KEYS}
    try:
        result = lib(pkg, 'fleetsim.sim').run_fleet(config)
    finally:
        mp.undo()
    env_after = {k: os.environ.get(k) for k in ENV_KEYS}
    return {'result': result, 'counts': counts, 'env': (env_before,
                                                        env_after)}


@pytest.fixture(scope='module')
def smoke_runs(tmp_path_factory):
    out = {}
    for pkg in PACKAGES:
        db = str(tmp_path_factory.mktemp(f'fleet-{pkg}') / 'fleet.db')
        sim = lib(pkg, 'fleetsim.sim')
        out[pkg] = dict(_counted_run(pkg, sim.fleet_config(smoke=True,
                                                           db=db)), db=db)
    return out


def _replica_rows(db):
    conn = sqlite3.connect(db)
    rows = sorted(conn.execute(
        'SELECT status, role, is_spot, COUNT(*) FROM replicas '
        'GROUP BY status, role, is_spot'))
    conn.close()
    return rows


def test_smoke_fleet_equals_jax_and_restores_the_environment(smoke_runs):
    jax_run, port = smoke_runs['skypilot_tpu'], smoke_runs[
        'skypilot_tpu_torch']
    assert comparable(port['result']) == comparable(jax_run['result'])
    assert port['counts'] == jax_run['counts']
    assert port['db'] != jax_run['db']
    assert _replica_rows(port['db']) == _replica_rows(jax_run['db'])
    for run in (jax_run, port):
        before, after = run['env']
        assert after == before


def test_smoke_fleet_headline(smoke_runs):
    result = smoke_runs['skypilot_tpu_torch']['result']
    slo_sim = lib('skypilot_tpu_torch', 'serve.slo_sim')
    assert result.pools == 2
    assert result.admitted > 1_000
    assert result.peak_replicas > 20
    assert result.backend == 'sqlite'
    assert result.seed == slo_sim.FLEET_SEED
    assert result.storm_fraction_pct == 50.0
    assert result.recovery_s is not None and result.recovery_s > 0
    assert result.lease_frozen_s == pytest.approx(3.0)
    assert 0.0 < result.prefix_hit_rate < 1.0
    assert 'preemption storm' in result.headline()


def test_smoke_fleet_drives_real_control_stack(smoke_runs):
    run = smoke_runs['skypilot_tpu_torch']
    result, counts = run['result'], run['counts']
    unfrozen = int(result.horizon_s) - int(result.lease_frozen_s)
    assert counts['evaluate_pools'] == unfrozen
    assert counts['try_acquire_singleton'] == unfrozen
    assert counts['policy_select'] >= result.admitted
    assert counts['pick_decode_targets'] == result.admitted


@pytest.mark.parametrize('pkg', PACKAGES)
def test_smoke_fleet_rows_and_lease_in_its_own_file(smoke_runs, pkg):
    """Each run's replica lifecycle and lease takeover landed in its own
    sqlite file (the DSN run_fleet pointed its package at)."""
    conn = sqlite3.connect(smoke_runs[pkg]['db'])
    rows = dict(conn.execute(
        'SELECT status, COUNT(*) FROM replicas GROUP BY status'))
    roles = dict(conn.execute(
        "SELECT role, COUNT(*) FROM replicas WHERE status='READY' "
        'GROUP BY role'))
    bad = conn.execute(
        "SELECT COUNT(*) FROM replicas WHERE status='PREEMPTED' AND "
        "(is_spot=0 OR role!='decode')").fetchone()[0]
    holders = [r[0] for r in conn.execute(
        'SELECT instance_id FROM singleton_leases')]
    conn.close()
    assert rows.get('PREEMPTED', 0) > 0 and rows.get('READY', 0) > 0
    assert roles.get('prefill', 0) > 0 and roles.get('decode', 0) > 0
    assert bad == 0
    assert holders and all('virtual' not in h for h in holders), holders


def test_smoke_fleet_history_shows_storm_dip(smoke_runs):
    result = smoke_runs['skypilot_tpu_torch']['result']
    by_t = {h['t']: h for h in result.history}
    before, after = by_t[19.0]['ready_decode'], by_t[20.0]['ready_decode']
    assert after <= before * 0.6 + 1
    assert result.history[-1]['ready_decode'] >= before * 0.9


def test_smoke_fleet_profile_ranks_hot_paths(smoke_runs):
    """The profile is the port's own registry's delta over the run."""
    profile = lib('skypilot_tpu_torch', 'fleetsim.profile')
    result = smoke_runs['skypilot_tpu_torch']['result']
    paths = [row['path'] for row in result.profile]
    assert any(p.startswith('db.') and p.endswith('[sqlite]')
               for p in paths)
    assert any(p.startswith('fleetsim.') for p in paths)
    top3 = profile.top(result.profile)
    assert len(top3) == 3
    assert result.profile[0]['seconds'] >= result.profile[-1]['seconds']
    report = profile.render_report(result.profile)
    assert 'control-plane path' in report and top3[0] in report


def test_smoke_fleet_alert_timeline(smoke_runs):
    sim = lib('skypilot_tpu_torch', 'fleetsim.sim')
    result = smoke_runs['skypilot_tpu_torch']['result']
    cfg = sim.fleet_config(smoke=True)
    events = {type(e).__name__: e for e in cfg.scenario.events}
    storm, kill = events['PreemptionStorm'], events['LeaseholderKill']
    by_rule = {a['rule']: a for a in result.alerts}
    tpot = by_rule['tpot_slo_burn']
    assert tpot['pool'] == 'decode' and tpot['state'] == 'cleared'
    assert tpot['fired_at_s'] <= storm.at_s + cfg.provision_delay_s
    assert tpot['cleared_at_s'] > storm.at_s + cfg.provision_delay_s
    assert tpot['burn'] > 1.0
    dark = by_rule['dark_scrape']
    assert dark['fired_at_s'] == pytest.approx(
        kill.at_s + result.lease_frozen_s)
    assert dark['state'] == 'cleared'
    assert dark['cleared_at_s'] > dark['fired_at_s']
    assert [(a['rule'], a['fired_at_s'], a['cleared_at_s'])
            for a in result.alerts] == [('tpot_slo_burn', 18.0, 34.0),
                                        ('dark_scrape', 24.0, 27.0)]


def test_virtual_manager_overrides_only_the_cloud_boundary():
    for pkg in PACKAGES:
        manager = lib(pkg, 'fleetsim.sim').VirtualReplicaManager
        overridden = {name for name in vars(manager)
                      if not name.startswith('__') or name == '__init__'}
        assert overridden == {'__init__', '_launch_replica',
                              '_teardown_cluster'}, pkg


def test_undersized_prefill_sheds_and_retries(tmp_path):
    sim = lib('skypilot_tpu_torch', 'fleetsim.sim')
    cfg = sim.fleet_config(smoke=True, seed=11, db=str(tmp_path / 'shed.db'))
    cfg.horizon_s = 20.0
    cfg.scenario = lib('skypilot_tpu_torch', 'fleetsim.scenario').Scenario()
    cfg.traffic = dataclasses.replace(cfg.traffic, base_qps=40.0, bursts=())
    cfg.prefill_replicas = 2
    cfg.decode_base_replicas = 4
    cfg.decode_max_replicas = 16
    cfg.max_queue_tokens_per_replica = 150
    result = sim.run_fleet(cfg)
    assert result.shed > 0 and result.retried > 0
    assert result.sustained_qps_at_slo < 40.0
    shed_ticks = [h for h in result.history if h['shed'] > 0]
    assert shed_ticks and all(not h['healthy'] for h in shed_ticks)


def test_fleet_runs_are_deterministic():
    sim = lib('skypilot_tpu_torch', 'fleetsim.sim')

    def run(seed):
        cfg = sim.fleet_config(smoke=True, seed=seed)
        cfg.horizon_s = 25.0
        return comparable(sim.run_fleet(cfg))

    a, b, c = run(5), run(5), run(6)
    assert a == b
    assert a != c


def test_profile_diff_ranks_by_elapsed_seconds():
    profile = lib('skypilot_tpu_torch', 'fleetsim.profile')
    metrics = lib('skypilot_tpu_torch', 'server.metrics')
    metrics.reset_for_tests()
    before = profile.snapshot()
    metrics.observe_hist('skytpu_db_op_seconds', 0.5, backend='sqlite',
                         op='query')
    metrics.observe_hist('skytpu_fleetsim_control_seconds', 0.2,
                         path='lb.route')
    metrics.observe_hist('skytpu_fleetsim_control_seconds', 0.1,
                         path='lb.route')
    rows = profile.diff(before, profile.snapshot())
    assert [(r['path'], r['calls']) for r in rows] == [
        ('db.query[sqlite]', 1), ('fleetsim.lb.route', 2)]
    assert rows[0]['seconds'] == pytest.approx(0.5)
    assert rows[1]['seconds'] == pytest.approx(0.3, abs=1e-6)
    assert rows[1]['mean_ms'] == pytest.approx(150.0)
    assert profile.top(rows, 1) == ['db.query[sqlite]']
    assert profile.diff(profile.snapshot(), profile.snapshot()) == []


# ---------------------------------------------------------------------------
# The canonical fleet, once per package
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def canonical(tmp_path_factory):
    out = {}
    for pkg in PACKAGES:
        db = str(tmp_path_factory.mktemp(f'canon-{pkg}') / 'fleet.db')
        sim = lib(pkg, 'fleetsim.sim')
        out[pkg] = comparable(sim.run_fleet(sim.fleet_config(db=db)))
    return out


def test_canonical_fleet_equals_jax_and_the_readme(canonical):
    assert canonical['skypilot_tpu_torch'] == canonical['skypilot_tpu']
    headline = canonical['skypilot_tpu_torch']['headline']
    assert headline == ('sustains 2803 req/s at SLO with 1798 virtual '
                        'replicas across 2 pools; recovers from a 50% '
                        'preemption storm in 8.0 s')
    with open(os.path.join(REPO, 'README.md'), encoding='utf-8') as f:
        readme = ' '.join(f.read().split())
    assert headline in readme


def test_chip_smoke_fleet_reference_is_the_jax_result(canonical):
    """chip_smoke.py's constants (it imports nothing of the JAX package)
    are the JAX run's, and its gate passes on the port's run."""
    want = canonical['skypilot_tpu']
    ref = chip_smoke.FLEET_REFERENCE
    for key in chip_smoke.FLEET_FIELDS:
        assert ref[key] == want[key], key
    assert ref['alerts'] == [(a['rule'], a['pool'], a['fired_at_s'],
                              a['cleared_at_s']) for a in want['alerts']]
    assert ref['digest'] == chip_smoke.fleet_digest(want)
    chip_smoke.check_fleet(canonical['skypilot_tpu_torch'])


# ---------------------------------------------------------------------------
# The goodput sim
# ---------------------------------------------------------------------------
def _goodput_runs(tmp_path, **scenario):
    out = {}
    for pkg in PACKAGES:
        run = lib(pkg, 'fleetsim.goodput_run')
        out[pkg] = run.run_goodput_sim(
            run.GoodputScenario(**scenario),
            ledger_dsn=str(tmp_path / f'{pkg}-ledger.db'),
            store_dsn=str(tmp_path / f'{pkg}-store.db'))
    assert out['skypilot_tpu_torch'] == out['skypilot_tpu']
    return out['skypilot_tpu_torch']


def test_goodput_sim_detects_the_planted_straggler_as_jax(tmp_path):
    goodput = lib('skypilot_tpu_torch', 'obs.goodput')
    sc = lib('skypilot_tpu_torch', 'fleetsim.goodput_run').GoodputScenario(
        slow_host=2)
    res = _goodput_runs(tmp_path, slow_host=2)
    assert res['ledger_vs_wall_pct'] < 1e-6
    expected_wall = (2 * sc.init_compile_s + sc.restore_s + sc.detect_s +
                     sc.relaunch_s +
                     sc.steps * (sc.step_s * sc.slow_factor + sc.stall_s) +
                     (sc.steps // sc.checkpoint_every) * sc.checkpoint_s)
    assert res['sim_wall_s'] == pytest.approx(expected_wall)
    assert res['goodput_pct'] == pytest.approx(
        100.0 * sc.steps * sc.step_s * sc.slow_factor / expected_wall)
    assert res['downtime_s'] == pytest.approx(sc.detect_s + sc.relaunch_s)
    p = res['preemption']
    assert res['preemption_intervals'] == [
        {'category': goodput.PREEMPTION_DOWNTIME,
         't0': pytest.approx(p['t_lost']), 't1': pytest.approx(p['t_detect'])}]
    assert res['relaunch_intervals'][0]['t0'] == pytest.approx(p['t_detect'])
    assert res['relaunch_intervals'][0]['t1'] == pytest.approx(p['t_up'])
    assert res['skew']['slow_host'] == 'host2' and res['skew']['skew'] > 1.3
    assert {'straggler', 'goodput_low'} <= set(res['active_alerts'])
    chip_smoke.check_goodput(res)


def test_goodput_sim_healthy_run_is_quiet_as_jax(tmp_path):
    res = _goodput_runs(tmp_path, slow_host=-1, preempt_at_step=-1,
                        steps=100, init_compile_s=1.0, stall_s=0.001)
    assert res['ledger_vs_wall_pct'] < 1e-6
    assert res['goodput_pct'] > 80.0
    assert res['downtime_s'] == 0.0
    assert res['preemption'] is None
    assert res['active_alerts'] == []
    assert res['skew'] is None or res['skew']['skew'] < 1.1


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------
def _cli(pkg, db, *flags):
    return subprocess.run(
        [sys.executable, *flags, '-m', f'{pkg}.fleetsim', '--smoke',
         '--json', '--db', db],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)


def test_cli_smoke_json_equals_jax_cli_without_torch_or_jax(tmp_path):
    import json
    port = _cli('skypilot_tpu_torch', str(tmp_path / 'port.db'), '-X',
                'importtime')
    jax_cli = _cli('skypilot_tpu', str(tmp_path / 'jax.db'))
    assert port.returncode == 0, port.stderr[-4000:]
    assert jax_cli.returncode == 0, jax_cli.stderr[-4000:]
    got, want = json.loads(port.stdout), json.loads(jax_cli.stdout)
    for out in (got, want):
        del out['profile'], out['wall_s']
    assert got == want
    assert got['headline'].startswith('sustains ')
    imported = chip_smoke.imported_top_level(port.stderr)
    assert 'skypilot_tpu_torch' in imported
    assert not imported & {'torch', 'jax', 'jaxlib', 'flax', 'skypilot_tpu'}


# ---------------------------------------------------------------------------
# Postgres (the CI service-container job; skips without it)
# ---------------------------------------------------------------------------
@pytest.mark.slow
@needs_pg
def test_postgres_fleet_storm_profiles_hot_paths():
    sim = lib('skypilot_tpu_torch', 'fleetsim.sim')
    profile = lib('skypilot_tpu_torch', 'fleetsim.profile')
    with pg_schema('fleetsim_torch') as url:
        cfg = sim.fleet_config(smoke=True, db=url)
        cfg.traffic = dataclasses.replace(cfg.traffic, base_qps=96.0)
        result = sim.run_fleet(cfg)
    lib('skypilot_tpu_torch', 'utils.db_utils').reset_connections_for_tests()
    assert result.backend == 'postgres'
    assert result.admitted > 1_000
    assert result.storm_fraction_pct == 50.0
    assert result.recovery_s is not None
    assert result.lease_frozen_s == pytest.approx(cfg.lease_ttl_s)
    paths = [row['path'] for row in result.profile]
    assert any(p.startswith('db.') and p.endswith('[postgres]')
               for p in paths)
    assert len(profile.top(result.profile)) == 3
