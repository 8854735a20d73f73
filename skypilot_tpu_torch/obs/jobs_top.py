"""`skytpu jobs top <job>`: the per-job goodput view.

The training twin of `skytpu top` — same posture (pure store/ledger
reader, side-effect-free `render()`, loop in `run()`), different
questions: what fraction of this job's wall-clock produced gradients,
where did the rest go, which host is dragging the pod, and what did
each recovery cost.  Every number comes from durable state (the
goodput ledger + the telemetry store), so a DEAD job renders the same
postmortem a live one renders as a dashboard:

    JOB 7 demo-ft (RUNNING)  goodput 87.3%  wall 412s  recoveries 1
    BADPUT  █████████████████████▒▒▒  productive 87.3%
      checkpoint_save        18.2s   4.4%
      preemption_downtime     9.8s   2.4%
      ...
    HOST       p50 STEP  TREND
    host0        102ms   ▃▃▄▃▃▃
    host1        251ms   ▆▇████   <- slow
    skew 2.46 (slow host1)
    RECOVERY TIMELINE:
      t=1700000123 preemption_downtime 9.8s
      t=1700000133 recovery_relaunch 13.1s
    ALERTS: straggler[train] firing since t=1700000200 (burn 1.9)
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from skypilot_tpu_torch.obs import goodput as goodput_lib
from skypilot_tpu_torch.obs import top as top_lib
from skypilot_tpu_torch.server import metrics as metrics_lib


def service_of(job: str) -> str:
    """Telemetry-store service scope for a managed job's worker
    scrapes — matches the flight-recorder rid convention."""
    return f'job-{job}'


def snapshot(job: str,
             ledger: Optional[goodput_lib.GoodputLedger] = None,
             store=None,
             job_rec: Optional[Dict] = None,
             now: Optional[float] = None,
             window: float = 300.0) -> Dict:
    """One frame's data.  ``store`` (a TelemetryStore over the job's
    step-time telemetry, service ``job-<id>``) is optional: without it
    the frame still renders the ledger breakdown and recovery timeline
    — the minimum postmortem — just no per-host rows or alerts."""
    job = str(job)
    ledger = ledger or goodput_lib.GoodputLedger()
    totals = ledger.totals(job)
    wall = sum(totals.values())
    badput = [
        {'category': cat, 'seconds': totals[cat],
         'pct': 100.0 * totals[cat] / wall if wall > 0 else 0.0}
        for cat in goodput_lib.BADPUT_CATEGORIES if cat in totals]
    badput.sort(key=lambda b: -b['seconds'])
    recoveries = [iv for iv in ledger.intervals(job)
                  if iv['category'] in goodput_lib.CONTROLLER_CATEGORIES]

    hosts: List[Dict] = []
    skew = None
    alerts: List[Dict] = []
    if store is not None:
        service = service_of(job)
        if now is None:
            # Anchor on the newest ingested interval (same postmortem
            # posture as `skytpu top`: a dead job shows its last
            # window, not an empty frame).
            now = store.last_t(service)
            now = time.time() if now is None else now
        t0, t1 = now - window, now
        by_host = store.histogram_window_by_replica(
            service, metrics_lib.TRAIN_STEP_FAMILY, t0, t1)
        res = max(store.resolution, 1e-9)
        skew_res = goodput_lib.step_time_skew(store, service, t0, t1)
        from skypilot_tpu_torch.serve import metrics_math
        for host in sorted(h for h in by_host if h):
            # Per-interval p50 strip: one quantile per resolution
            # interval, same shape as top.py's tpot strip.
            strip = _p50_strip(store, service, host, t1,
                               min(window, 24 * res), res)
            p50 = metrics_math.quantile_from_cumulative(
                by_host[host], 0.5)
            hosts.append({'host': host, 'p50_s': p50, 'strip': strip})
        skew = skew_res
        alerts = store.active_alerts(service)

    return {
        'job': job,
        'name': (job_rec or {}).get('name'),
        'status': (job_rec or {}).get('status'),
        'recovery_count': (job_rec or {}).get('recovery_count'),
        'goodput_pct': (100.0 * totals.get(goodput_lib.PRODUCTIVE, 0.0)
                        / wall if wall > 0 else None),
        'wall_s': wall,
        'productive_s': totals.get(goodput_lib.PRODUCTIVE, 0.0),
        'badput': badput,
        'recoveries': recoveries,
        'hosts': hosts,
        'skew': skew,
        'alerts': alerts,
    }


def _p50_strip(store, service: str, host: str, t1: float,
               span: float, res: float) -> List[float]:
    from skypilot_tpu_torch.serve import metrics_math
    strip: List[float] = []
    t = t1 - span
    while t < t1:
        cum = store.histogram_window_by_replica(
            service, metrics_lib.TRAIN_STEP_FAMILY, t, t + res
        ).get(host)
        if cum:
            q = metrics_math.quantile_from_cumulative(cum, 0.5)
            if q is not None:
                strip.append(q)
        t += res
    return strip


def _badput_bar(goodput_pct: Optional[float], width: int = 24) -> str:
    if goodput_pct is None:
        return ''
    filled = int(round(width * goodput_pct / 100.0))
    return '█' * filled + '▒' * (width - filled)


def render(snap: Dict) -> str:
    """A snapshot as the fixed-layout text frame."""
    name = f" {snap['name']}" if snap.get('name') else ''
    status = f" ({snap['status']})" if snap.get('status') else ''
    head = f"JOB {snap['job']}{name}{status}"
    gp = snap['goodput_pct']
    head += (f"  goodput {gp:.1f}%" if gp is not None
             else '  goodput --')
    head += f"  wall {snap['wall_s']:.0f}s"
    if snap.get('recovery_count') is not None:
        head += f"  recoveries {snap['recovery_count']}"
    lines = [head]
    if gp is not None:
        lines.append(f"BADPUT  {_badput_bar(gp)}  "
                     f"productive {gp:.1f}%")
    for b in snap['badput']:
        lines.append(f"  {b['category']:<20}{b['seconds']:>9.1f}s"
                     f"{b['pct']:>6.1f}%")
    if snap['hosts']:
        lines.append(f"{'HOST':<12}{'p50 STEP':>10}  TREND")
        slow = (snap['skew'] or {}).get('slow_host')
        for h in snap['hosts']:
            mark = '   <- slow' if h['host'] == slow else ''
            lines.append(
                f"{h['host']:<12}{top_lib._fmt_ms(h['p50_s']):>10}  "
                f"{top_lib.sparkline(h['strip'])}{mark}")
    if snap['skew'] is not None:
        lines.append(f"skew {snap['skew']['skew']:.2f} "
                     f"(slow {snap['skew']['slow_host']})")
    if snap['recoveries']:
        lines.append('RECOVERY TIMELINE:')
        for iv in snap['recoveries']:
            lines.append(f"  t={iv['t0']:.0f} {iv['category']} "
                         f"{iv['t1'] - iv['t0']:.1f}s")
    if snap['alerts']:
        for a in snap['alerts']:
            pool = f"[{a['pool']}]" if a['pool'] else ''
            lines.append(
                f"ALERT {a['rule']}{pool} firing since "
                f"t={a['fired_at']:.0f} (burn {a['burn']})")
    else:
        lines.append('ALERTS: none')
    return '\n'.join(lines)


def run(job: str,
        ledger: Optional[goodput_lib.GoodputLedger] = None,
        store=None,
        interval: float = 2.0,
        iterations: Optional[int] = None,
        window: float = 300.0) -> int:
    """The interactive loop; iterations=1 gives one plain frame (and
    is how a dead job's postmortem is printed)."""
    from skypilot_tpu_torch.jobs import state as jobs_state
    shown = 0
    try:
        while iterations is None or shown < iterations:
            try:
                rec = jobs_state.get(int(job))
            except Exception:  # pylint: disable=broad-except
                rec = None  # non-numeric job key or no jobs db yet
            frame = render(snapshot(job, ledger=ledger, store=store,
                                    job_rec=rec, window=window))
            if iterations is None or iterations > 1:
                print('\033[2J\033[H', end='')
            print(frame)
            shown += 1
            if iterations is not None and shown >= iterations:
                break
            time.sleep(interval)
    except KeyboardInterrupt:
        pass
    return 0
