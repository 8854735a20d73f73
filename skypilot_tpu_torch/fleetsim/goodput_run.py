"""Zero-hardware goodput-plane proof: a simulated multi-host training
job driven through the REAL goodput stack.

Same posture as the serving fleetsim: the *job* is virtual (phase
durations and per-host step times come from a sim clock, no XLA), but
every plane under test is production code — :class:`PhaseRecorder`
tiling, the durable :class:`GoodputLedger` (sqlite or Postgres),
controller-style downtime writes for an injected mid-run preemption,
per-host step-time scrapes downsampled through the telemetry store's
host sub-label, skew derivation, and the `goodput_low`/`straggler`
alert rules on the multi-window engine.  The run returns everything
the bench artifact and the tests pin: the badput breakdown, the exact
ledger-vs-sim-wall agreement, the preemption/relaunch intervals, the
derived skew, and the alert transitions.

Wall-clock here is SIM time throughout (the recorder gets an injected
clock with an identity wall mapping), so the ledger numbers are
deterministic and the tiling check is exact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from skypilot_tpu_torch.obs import alerts as alerts_lib
from skypilot_tpu_torch.obs import goodput as goodput_lib
from skypilot_tpu_torch.obs import store as store_lib
from skypilot_tpu_torch.server import metrics as metrics_lib


@dataclasses.dataclass(frozen=True)
class GoodputScenario:
    """One simulated managed job with a mid-run preemption."""
    job: str = 'sim-1'
    hosts: int = 4
    slow_host: int = -1              # index; -1 = no straggler
    slow_factor: float = 3.0         # slow host's step-time multiple
    steps: int = 200
    step_s: float = 0.5
    stall_s: float = 0.02            # per-step input wait (carved)
    init_compile_s: float = 30.0
    checkpoint_every: int = 50
    checkpoint_s: float = 2.0
    restore_s: float = 5.0
    preempt_at_step: int = 120       # -1 = no preemption
    detect_s: float = 8.0            # loss -> controller notices
    relaunch_s: float = 25.0         # teardown + provision + resubmit
    scrape_every: int = 10           # steps per federated scrape


def run_goodput_sim(scenario: Optional[GoodputScenario] = None,
                    ledger_dsn: Optional[str] = None,
                    store_dsn: Optional[str] = None) -> Dict:
    """Run the scenario; returns the pinned result dict.

    ``ledger_dsn``/``store_dsn`` default to in-repo temp-style sqlite
    paths ONLY when given — callers (bench, tests) should pass
    explicit paths; the Postgres conformance job passes DSNs.
    """
    sc = scenario or GoodputScenario()
    if ledger_dsn is None or store_dsn is None:
        raise ValueError('run_goodput_sim needs explicit ledger_dsn '
                         'and store_dsn (sqlite path or postgres DSN)')
    clock = [0.0]

    def now() -> float:
        return clock[0]

    def advance(dt: float) -> None:
        clock[0] += dt

    ledger = goodput_lib.GoodputLedger(ledger_dsn)
    store = store_lib.TelemetryStore(store_dsn, resolution=5.0,
                                     retention=10 ** 9)
    service = f'job-{sc.job}'
    engine = alerts_lib.AlertEngine(
        store, service, alerts_lib.train_rules(),
        windows=alerts_lib.BurnWindows(fast=(30.0, 60.0),
                                       slow=(60.0, 120.0)))
    # Per-host cumulative step-time histograms rendered as one
    # federated exposition per scrape (what the real controller sees).
    metrics_lib.reset_for_tests()

    def step_time(host: int) -> float:
        if sc.slow_host >= 0 and host == sc.slow_host:
            return sc.step_s * sc.slow_factor
        return sc.step_s

    def sim_steps(rec: goodput_lib.PhaseRecorder, first: int,
                  last: int) -> None:
        """Steps [first, last): productive time + carved stalls +
        checkpoints + periodic scrapes, on the sim clock.  A
        synchronous pod steps at the SLOWEST host's pace."""
        pace = max(step_time(h) for h in range(sc.hosts))
        for i in range(first, last):
            advance(sc.stall_s)
            rec.carve(goodput_lib.INPUT_STALL, sc.stall_s)
            advance(pace)
            for h in range(sc.hosts):
                metrics_lib.observe_hist(
                    'skytpu_train_step_seconds', step_time(h),
                    host=f'host{h}')
            if sc.checkpoint_every and \
                    (i + 1) % sc.checkpoint_every == 0:
                rec.begin(goodput_lib.CHECKPOINT_SAVE)
                advance(sc.checkpoint_s)
                rec.begin(goodput_lib.PRODUCTIVE)
            if (i + 1) % sc.scrape_every == 0:
                gauge = rec.goodput_pct()
                if gauge is not None:
                    metrics_lib.set_gauge(
                        metrics_lib.TRAIN_GOODPUT_FAMILY, gauge)
                # The production controller tick: ingest the federated
                # scrape, derive skew, evaluate the train rules.
                goodput_lib.train_obs_tick(
                    store, service, metrics_lib.render(), now(),
                    engine=engine)

    t_start = now()
    # ---- incarnation 1: init, train, die at preempt_at_step --------------
    rec = goodput_lib.PhaseRecorder(job=sc.job, ledger=ledger,
                                    clock=now, to_wall=lambda t: t)
    rec.begin(goodput_lib.INIT_COMPILE)
    advance(sc.init_compile_s)
    rec.begin(goodput_lib.PRODUCTIVE)
    cut = sc.steps if sc.preempt_at_step < 0 else sc.preempt_at_step
    sim_steps(rec, 0, cut)
    preemption = None
    if sc.preempt_at_step >= 0:
        # The slice dies: the worker's recorder flushes what it has
        # (mirrors Trainer.run's roll-at-end; a real SIGKILL mid-window
        # loses at most one open interval, which the tiling tests
        # bound).
        rec.close()
        t_lost = now()
        advance(sc.detect_s)     # controller's next poll notices
        t_detect = now()
        advance(sc.relaunch_s)   # teardown + reprovision + resubmit
        t_up = now()
        # Controller-side ledger writes (jobs/controller._record_downtime
        # semantics: downtime anchored at the last healthy poll).
        ledger.add(sc.job, goodput_lib.PREEMPTION_DOWNTIME,
                   t_detect - t_lost, t0=t_lost, t1=t_detect)
        ledger.add(sc.job, goodput_lib.RECOVERY_RELAUNCH,
                   t_up - t_detect, t0=t_detect, t1=t_up)
        preemption = {'t_lost': t_lost, 't_detect': t_detect,
                      't_up': t_up}
        # ---- incarnation 2: restore and finish -------------------------------
        rec = goodput_lib.PhaseRecorder(job=sc.job, ledger=ledger,
                                        clock=now, to_wall=lambda t: t)
        rec.begin(goodput_lib.INIT_COMPILE)
        advance(sc.init_compile_s)
        rec.begin(goodput_lib.CHECKPOINT_RESTORE)
        advance(sc.restore_s)
        rec.begin(goodput_lib.PRODUCTIVE)
        sim_steps(rec, cut, sc.steps)
    rec.close()
    sim_wall = now() - t_start

    totals = ledger.totals(sc.job)
    ledger_wall = sum(totals.values())
    skew = goodput_lib.step_time_skew(store, service, t_start, now())
    return {
        'job': sc.job,
        'sim_wall_s': sim_wall,
        'ledger_wall_s': ledger_wall,
        'ledger_vs_wall_pct': (100.0 * abs(ledger_wall - sim_wall)
                               / sim_wall if sim_wall > 0 else 0.0),
        'goodput_pct': ledger.goodput_pct(sc.job),
        'totals': totals,
        'downtime_s': ledger.downtime_s(sc.job),
        'preemption': preemption,
        'preemption_intervals': ledger.intervals(
            sc.job, goodput_lib.PREEMPTION_DOWNTIME),
        'relaunch_intervals': ledger.intervals(
            sc.job, goodput_lib.RECOVERY_RELAUNCH),
        'skew': skew,
        'active_alerts': [a['rule']
                          for a in store.active_alerts(service)],
    }
