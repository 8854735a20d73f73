"""The port's durable goodput ledger and straggler detection
(`skypilot_tpu_torch/obs/goodput.py`, a verbatim copy of the JAX
package's, over the port's copies of the control-plane store): mirrors
tests/test_goodput.py's ledger, tiling and skew cases, then holds the
port against the JAX package on one sqlite file:

- additive upserts and queries, durability across ledger re-opens (on
  sqlite, and on Postgres when SKYTPU_TEST_PG_URL is set);
- the recorder's deterministic tiling, the fuzzed tiling property and
  the live views; a hypothesis property that the JAX and the port
  recorders, fed one fake clock and one begin/carve/close script, write
  identical totals and interval rows;
- ledger rows the port writes are read by the JAX `GoodputLedger`, and
  the reverse (what the JAX controller, `jobs queue` and `jobs top`
  read of a port trainer's job);
- the host sub-label through the store, and the JAX and port straggler
  functions (`step_time_skew`, `evaluate_stragglers`, `train_obs_tick`)
  giving the same skew and verdict on the same rows;
- the port Trainer's exposition carries the families `train_obs_tick`
  reads.
"""
import math
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pg_utils import BACKENDS, pg_schema
from skypilot_tpu import state as jax_state
from skypilot_tpu.obs import goodput as jax_goodput
from skypilot_tpu.obs import store as jax_store
from skypilot_tpu.server import metrics as jax_metrics
from skypilot_tpu.server import tracing as jax_tracing
from skypilot_tpu.utils import db_utils as jax_db_utils
from skypilot_tpu_torch import state as torch_state
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.obs import goodput
from skypilot_tpu_torch.obs import store as obs_store
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing
from skypilot_tpu_torch.train import trainer as tt
from skypilot_tpu_torch.utils import db_utils

torch.set_num_threads(1)

STEP = metrics_lib.TRAIN_STEP_FAMILY
T0 = 1_000_000.0


def _reset_all():
    for lib in (metrics_lib, tracing, jax_metrics, jax_tracing):
        lib.reset_for_tests()


@pytest.fixture(autouse=True)
def _reset():
    _reset_all()
    yield
    _reset_all()
    torch_state.reset_connections_for_tests()
    jax_state.reset_connections_for_tests()


@pytest.fixture(params=BACKENDS)
def backend_url(request):
    """None for sqlite; a schema-scoped Postgres URL otherwise (skipped
    without SKYTPU_TEST_PG_URL), with both packages' connection and
    schema caches reset after it."""
    if request.param == 'sqlite':
        yield None
    else:
        with pg_schema('tgoodput') as url:
            yield url
        db_utils.reset_connections_for_tests()
        jax_db_utils.reset_connections_for_tests()


@pytest.fixture
def dsn(backend_url, tmp_path):
    return backend_url or str(tmp_path / 'goodput.db')


def _train_expo(step_counts, goodput_pct=None):
    """A worker's cumulative exposition: host-labeled step-time
    histogram (fast steps in the 0.1 s bucket, slow ones in the 0.5 s
    bucket) + the goodput gauge.  step_counts: {host: (fast_n, slow_n)}."""
    lines = []
    for host, (fast, slow) in sorted(step_counts.items()):
        lines += [
            f'{STEP}_bucket{{le="0.1",host="{host}"}} {fast}',
            f'{STEP}_bucket{{le="0.5",host="{host}"}} {fast + slow}',
            f'{STEP}_bucket{{le="+Inf",host="{host}"}} {fast + slow}',
        ]
    if goodput_pct is not None:
        lines.append(f'{metrics_lib.TRAIN_GOODPUT_FAMILY} {goodput_pct}')
    return '\n'.join(lines) + '\n'


# ----- the ledger (sqlite, and Postgres when configured) ---------------------


def test_ledger_additive_upsert_and_queries(dsn):
    led = goodput.GoodputLedger(dsn)
    led.add('7', goodput.PRODUCTIVE, 100.0, t0=T0, t1=T0 + 100)
    led.add('7', goodput.PRODUCTIVE, 50.0, t0=T0 + 110, t1=T0 + 160)
    led.add('7', goodput.CHECKPOINT_SAVE, 6.0)
    led.add('7', goodput.PREEMPTION_DOWNTIME, 4.0, t0=T0 + 100,
            t1=T0 + 104)
    led.add('7', goodput.RECOVERY_RELAUNCH, 6.0, t0=T0 + 104, t1=T0 + 110)
    led.add('8', goodput.PRODUCTIVE, 10.0)
    totals = led.totals('7')
    assert totals[goodput.PRODUCTIVE] == pytest.approx(150.0)
    assert totals[goodput.CHECKPOINT_SAVE] == pytest.approx(6.0)
    assert led.wall('7') == pytest.approx(166.0)
    assert led.goodput_pct('7') == pytest.approx(100 * 150 / 166.0)
    assert led.downtime_s('7') == pytest.approx(10.0)
    assert led.downtime_by_job() == {'7': pytest.approx(10.0)}
    assert led.jobs() == ['7', '8']
    ivs = led.intervals('7')
    assert [iv['category'] for iv in ivs] == [
        goodput.PRODUCTIVE, goodput.PREEMPTION_DOWNTIME,
        goodput.RECOVERY_RELAUNCH, goodput.PRODUCTIVE]
    assert led.intervals('7', goodput.PREEMPTION_DOWNTIME) == [
        {'category': goodput.PREEMPTION_DOWNTIME,
         't0': T0 + 100, 't1': T0 + 104}]
    led.add('7', goodput.PRODUCTIVE, 0.0)
    led.add('7', goodput.PRODUCTIVE, -3.0)
    assert led.wall('7') == pytest.approx(166.0)
    with pytest.raises(ValueError, match='unknown goodput category'):
        led.add('7', 'coffee_break', 1.0)
    assert led.goodput_pct('nope') is None
    assert led.downtime_s('nope') == 0.0


def test_ledger_durable_across_controller_restart(dsn):
    goodput.GoodputLedger(dsn).add('42', goodput.PRODUCTIVE, 30.0)
    reopened = goodput.GoodputLedger(dsn)
    reopened.add('42', goodput.PRODUCTIVE, 12.0)
    reopened.add('42', goodput.RECOVERY_RELAUNCH, 5.0)
    torch_state.reset_connections_for_tests()
    assert goodput.GoodputLedger(dsn).totals('42') == {
        goodput.PRODUCTIVE: pytest.approx(42.0),
        goodput.RECOVERY_RELAUNCH: pytest.approx(5.0)}


def test_jobs_dsn_is_the_jobs_store(monkeypatch, tmp_path):
    monkeypatch.delenv('SKYTPU_DB_URL', raising=False)
    monkeypatch.setenv('SKYTPU_JOBS_DB', str(tmp_path / 'jobs.db'))
    assert goodput.jobs_dsn() == jax_goodput.jobs_dsn() == str(
        tmp_path / 'jobs.db')
    assert goodput.GoodputLedger().dsn == str(tmp_path / 'jobs.db')
    monkeypatch.setenv('SKYTPU_DB_URL', 'mysql://nope')
    with pytest.raises(ValueError, match='unsupported control-plane'):
        goodput.jobs_dsn()


# ----- the recorder's tiling -------------------------------------------------


def test_phase_recorder_deterministic_tiling(tmp_path):
    led = goodput.GoodputLedger(str(tmp_path / 'l.db'))
    clock = [100.0]
    rec = goodput.PhaseRecorder(job='d', ledger=led,
                                clock=lambda: clock[0], to_wall=lambda t: t)
    rec.begin(goodput.INIT_COMPILE)
    clock[0] += 30.0
    rec.begin(goodput.PRODUCTIVE)
    clock[0] += 50.0
    rec.carve(goodput.INPUT_STALL, 2.0)
    rec.begin(goodput.CHECKPOINT_SAVE)
    clock[0] += 4.0
    rec.begin(goodput.PRODUCTIVE)
    clock[0] += 16.0
    totals = rec.close()
    assert totals == {
        goodput.INIT_COMPILE: pytest.approx(30.0),
        goodput.PRODUCTIVE: pytest.approx(64.0),
        goodput.INPUT_STALL: pytest.approx(2.0),
        goodput.CHECKPOINT_SAVE: pytest.approx(4.0)}
    assert sum(totals.values()) == pytest.approx(100.0)
    assert led.totals('d') == {k: pytest.approx(v)
                               for k, v in totals.items()}
    ivs = led.intervals('d')
    assert ivs[0]['t0'] == pytest.approx(100.0)
    assert ivs[-1]['t1'] == pytest.approx(200.0)
    for a, b in zip(ivs, ivs[1:]):
        assert a['t1'] == pytest.approx(b['t0'], abs=1e-9)
    spans = [e for e in tracing.events_for('job-d')
             if e['name'] == goodput.PHASE_SPAN]
    assert len(spans) == len(ivs)
    assert spans[1]['attrs']['category'] == goodput.PRODUCTIVE
    assert spans[1]['attrs']['input_stall_s'] == pytest.approx(2.0)


def test_phase_recorder_tiling_property_under_fuzz(tmp_path):
    """Random phase sequences with over-carves, zero-length intervals and
    controller-written recoveries between incarnations: each
    incarnation's totals sum to its elapsed time, the durable ledger to
    the whole wall-clock, and interval rows never overlap."""
    rng = random.Random(20)
    led = goodput.GoodputLedger(str(tmp_path / 'l.db'))
    clock = [1000.0]
    wall = 0.0
    worker_cats = (goodput.PRODUCTIVE, goodput.INIT_COMPILE,
                   goodput.CHECKPOINT_SAVE, goodput.CHECKPOINT_RESTORE)
    for incarnation in range(4):
        rec = goodput.PhaseRecorder(job='p', ledger=led,
                                    clock=lambda: clock[0],
                                    to_wall=lambda t: t)
        start = clock[0]
        rec.begin(goodput.INIT_COMPILE)
        for _ in range(40):
            op = rng.random()
            if op < 0.4:
                rec.begin(rng.choice(worker_cats))
            elif op < 0.8:
                clock[0] += rng.uniform(0.01, 5.0)
            else:
                rec.carve(goodput.INPUT_STALL, rng.uniform(0.01, 20.0))
        totals = rec.close()
        elapsed = clock[0] - start
        assert sum(totals.values()) == pytest.approx(elapsed, abs=1e-9)
        assert all(v >= 0 for v in totals.values())
        wall += elapsed
        if incarnation < 3:
            t_lost = clock[0]
            clock[0] += rng.uniform(0.5, 5.0)
            t_detect = clock[0]
            clock[0] += rng.uniform(0.5, 10.0)
            t_up = clock[0]
            led.add('p', goodput.PREEMPTION_DOWNTIME, t_detect - t_lost,
                    t0=t_lost, t1=t_detect)
            led.add('p', goodput.RECOVERY_RELAUNCH, t_up - t_detect,
                    t0=t_detect, t1=t_up)
            wall += t_up - t_lost
    assert led.wall('p') == pytest.approx(wall, rel=1e-9)
    ivs = led.intervals('p')
    assert ivs
    for a, b in zip(ivs, ivs[1:]):
        assert a['t1'] > a['t0']
        assert a['t1'] <= b['t0'] + 1e-9


def test_phase_recorder_live_views_do_not_close():
    clock = [0.0]
    rec = goodput.PhaseRecorder(clock=lambda: clock[0])
    rec.begin(goodput.INIT_COMPILE)
    clock[0] = 10.0
    rec.begin(goodput.PRODUCTIVE)
    clock[0] = 40.0
    rec.carve(goodput.INPUT_STALL, 5.0)
    snap = rec.snapshot()
    assert snap[goodput.PRODUCTIVE] == pytest.approx(25.0)
    assert snap[goodput.INPUT_STALL] == pytest.approx(5.0)
    assert rec.goodput_pct() == pytest.approx(100 * 25 / 40.0)
    assert rec.productive_s() == pytest.approx(25.0)
    assert rec.category == goodput.PRODUCTIVE
    assert rec.totals == {goodput.INIT_COMPILE: pytest.approx(10.0)}
    clock[0] = 50.0
    assert rec.close()[goodput.PRODUCTIVE] == pytest.approx(35.0)


_OPS = st.lists(st.one_of(
    st.tuples(st.just('begin'), st.sampled_from(goodput.CATEGORIES)),
    st.tuples(st.just('tick'), st.floats(0.0, 50.0)),
    st.tuples(st.just('carve'), st.floats(0.0, 80.0)),
    st.tuples(st.just('close'), st.just(0.0))), min_size=1, max_size=30)


@settings(max_examples=40, deadline=None)
@given(ops=_OPS)
def test_recorders_write_identical_rows_under_one_script(tmp_path_factory,
                                                         ops):
    """One fake clock and one begin/tick/carve/close script through the
    JAX and the port recorders, each over its own ledger on one sqlite
    file: identical totals, ledger totals and interval rows, and the
    totals tile the elapsed time."""
    db = str(tmp_path_factory.mktemp('rows') / 'l.db')
    clock = [500.0]
    recs = [lib.PhaseRecorder(job=name, ledger=lib.GoodputLedger(db),
                              clock=lambda: clock[0], to_wall=lambda t: t)
            for name, lib in (('jax', jax_goodput), ('torch', goodput))]
    start = clock[0]
    for rec in recs:
        rec.begin(goodput.INIT_COMPILE)
    for op, arg in ops:
        if op == 'tick':
            clock[0] += arg
            continue
        for rec in recs:
            if op == 'begin':
                rec.begin(arg)
            elif op == 'carve':
                rec.carve(goodput.INPUT_STALL, arg)
            else:
                rec.close()
    totals = [rec.close() for rec in recs]
    assert totals[0] == totals[1]
    assert sum(totals[1].values()) <= clock[0] - start + 1e-6
    reader = jax_goodput.GoodputLedger(db)
    assert reader.totals('jax') == goodput.GoodputLedger(db).totals('torch')
    assert reader.intervals('jax') == reader.intervals('torch')
    jax_state.reset_connections_for_tests()
    torch_state.reset_connections_for_tests()


# ----- across packages on one sqlite file ------------------------------------


def test_ledger_rows_cross_packages(tmp_path):
    """What the port's trainer writes the JAX controller, `jobs queue`
    and `jobs top` read, and the controller's rows read back in the
    port; both accumulate into the same rows."""
    db = str(tmp_path / 'managed_jobs.db')
    port, ref = goodput.GoodputLedger(db), jax_goodput.GoodputLedger(db)
    port.add('9', goodput.INIT_COMPILE, 3.0, t0=T0, t1=T0 + 3)
    port.add('9', goodput.PRODUCTIVE, 40.0, t0=T0 + 3, t1=T0 + 43)
    ref.add('9', jax_goodput.PREEMPTION_DOWNTIME, 2.0, t0=T0 + 43,
            t1=T0 + 45)
    ref.add('9', jax_goodput.RECOVERY_RELAUNCH, 5.0, t0=T0 + 45,
            t1=T0 + 50)
    port.add('9', goodput.PRODUCTIVE, 10.0, t0=T0 + 50, t1=T0 + 60)
    for led in (port, ref):
        assert led.totals('9') == {
            goodput.INIT_COMPILE: 3.0, goodput.PRODUCTIVE: 50.0,
            goodput.PREEMPTION_DOWNTIME: 2.0,
            goodput.RECOVERY_RELAUNCH: 5.0}
        assert led.downtime_by_job() == {'9': 7.0}
        assert led.goodput_pct('9') == pytest.approx(100 * 50 / 60.0)
        assert [iv['t0'] for iv in led.intervals('9')] == [
            T0, T0 + 3, T0 + 43, T0 + 45, T0 + 50]
    assert port.intervals('9') == ref.intervals('9')


def test_durable_recorder_from_env_is_read_by_the_jax_ledger(monkeypatch,
                                                             tmp_path):
    monkeypatch.delenv('SKYTPU_DB_URL', raising=False)
    monkeypatch.setenv('SKYTPU_JOBS_DB', str(tmp_path / 'jobs.db'))
    monkeypatch.setenv(goodput.JOB_ENV, '12')
    port = goodput.PhaseRecorder.from_env()
    ref = jax_goodput.PhaseRecorder.from_env()
    assert port.ledger.dsn == ref.ledger.dsn
    port.begin(goodput.INIT_COMPILE, now=1.0)
    port.begin(goodput.PRODUCTIVE, now=4.0)
    port.carve(goodput.INPUT_STALL, 0.5)
    totals = port.close(now=9.0)
    assert ref.ledger.totals('12') == totals == {
        goodput.INIT_COMPILE: 3.0, goodput.PRODUCTIVE: 4.5,
        goodput.INPUT_STALL: 0.5}


# ----- the store and the straggler functions ---------------------------------


def test_store_keeps_host_sublabel_and_derives_skew(dsn):
    store = obs_store.TelemetryStore(dsn, resolution=1.0)
    svc = 'job-9'
    store.ingest(svc, _train_expo({'h0': (10, 0), 'h1': (0, 5)}), now=T0,
                 leader_check=False)
    store.ingest(svc, _train_expo({'h0': (30, 0), 'h1': (0, 15)}),
                 now=T0 + 1, leader_check=False)
    by_host = store.histogram_window_by_replica(svc, STEP, T0, T0 + 2)
    assert set(by_host) == {'h0', 'h1'}
    assert by_host['h0'][0.1] == pytest.approx(20.0)
    assert by_host['h1'][math.inf] == pytest.approx(10.0)
    skew = goodput.step_time_skew(store, svc, T0, T0 + 2)
    assert skew is not None and skew['slow_host'] == 'h1'
    assert skew['skew'] > 1.3
    assert set(skew['p50_by_host']) == {'h0', 'h1'}
    store.ingest('solo', _train_expo({'h0': (10, 0)}), now=T0,
                 leader_check=False)
    store.ingest('solo', _train_expo({'h0': (20, 0)}), now=T0 + 1,
                 leader_check=False)
    assert goodput.step_time_skew(store, 'solo', T0, T0 + 2) is None
    store.put_gauge(svc, metrics_lib.TRAIN_STEP_SKEW_FAMILY, 2.5, T0 + 1)
    store.put_gauge(svc, metrics_lib.TRAIN_STEP_SKEW_FAMILY, 1.0, T0 + 2)
    assert store.gauge_max(svc, metrics_lib.TRAIN_STEP_SKEW_FAMILY, T0,
                           T0 + 3) == pytest.approx(2.5)


@pytest.mark.parametrize('hosts', [
    {'h0': (30, 0), 'h1': (0, 15), 'h2': (25, 1)},   # a slow host
    {'h0': (30, 0), 'h1': (28, 2)},                  # balanced
    {'h0': (30, 0)},                                 # one host: no skew
])
def test_straggler_functions_match_the_jax_ones(tmp_path, hosts):
    """The same scrapes through each package's train_obs_tick (its own
    store file): the same skew result and the same derived gauge rows;
    and each package's step_time_skew over the rows the other wrote."""
    first = {h: (f // 3, s // 3) for h, (f, s) in hosts.items()}
    results, stores = {}, {}
    for name, store_lib, lib in (('jax', jax_store, jax_goodput),
                                 ('torch', obs_store, goodput)):
        store = store_lib.TelemetryStore(str(tmp_path / f'{name}.db'),
                                         resolution=1.0)
        got = [lib.train_obs_tick(store, 'job-3', _train_expo(counts, 80.0),
                                  now=T0 + i)
               for i, counts in enumerate((first, hosts))]
        results[name] = got
        stores[name] = store
    assert results['jax'] == results['torch']
    if len(hosts) > 1:
        assert results['torch'][1] is not None
    else:
        assert results['torch'] == [None, None]
    fam = metrics_lib.TRAIN_STEP_SKEW_FAMILY
    assert (stores['torch'].gauge_max('job-3', fam, T0 - 100, T0 + 100) ==
            stores['jax'].gauge_max('job-3', fam, T0 - 100, T0 + 100))
    cross = {
        'port over jax rows': goodput.step_time_skew(
            obs_store.TelemetryStore(stores['jax'].dsn, resolution=1.0),
            'job-3', T0 - 100, T0 + 100),
        'jax over port rows': jax_goodput.step_time_skew(
            jax_store.TelemetryStore(stores['torch'].dsn, resolution=1.0),
            'job-3', T0 - 100, T0 + 100)}
    want = goodput.step_time_skew(stores['torch'], 'job-3', T0 - 100,
                                  T0 + 100)
    assert cross == {key: want for key in cross}


def test_trainer_exposition_feeds_train_obs_tick(tmp_path):
    """Two port trainers (hosts h0, h1) on the CPU: their exposition
    carries the host-labelled step histogram and the goodput gauge, the
    port's train_obs_tick derives a skew over both hosts from it, and the
    JAX train_obs_tick reads the same exposition to the same result."""
    cfg = tl.LLAMA_CONFIGS['tiny']
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    trainers = [tt.Trainer(tl.Llama(cfg, tl.init_params(cfg, 'cpu')),
                           tt.TrainConfig(warmup_steps=1, total_steps=20),
                           host=host, device='cpu') for host in ('h0', 'h1')]
    stores = {name: lib.TelemetryStore(str(tmp_path / f'{name}.db'),
                                       resolution=1.0)
              for name, lib in (('torch', obs_store), ('jax', jax_store))}
    results = {'torch': [], 'jax': []}
    for i in range(2):
        for trainer in trainers:
            trainer.run(iter([batch] * 3), num_steps=3, log_every=3)
        text = metrics_lib.render()
        for name, lib in (('torch', goodput), ('jax', jax_goodput)):
            results[name].append(lib.train_obs_tick(stores[name], 'job-5',
                                                    text, now=T0 + i))
    assert f'{STEP}_bucket{{' in text and 'host="h1"' in text
    assert metrics_lib.TRAIN_GOODPUT_FAMILY in text
    by_host = stores['torch'].histogram_window_by_replica(
        'job-5', STEP, T0 - 1, T0 + 2)
    assert set(by_host) == {'h0', 'h1'}
    skew = results['torch'][1]
    assert skew is not None and set(skew['p50_by_host']) == {'h0', 'h1'}
    assert results['torch'] == results['jax']
