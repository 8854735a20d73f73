"""`skytpu top`: the live terminal fleet view over the telemetry store.

Pure store-reader — every number on screen comes through the same
query API the alert engine burns from, so what the operator watches
and what pages them can never disagree.  Layout per refresh:

    SERVICE llama-70b               2026-08-07 12:00:10  (res 10s)
    POOL      QPS   p95 TTFT  p95 TPOT    MFU  PREFIX%  FREE PG
    prefill  42.1     180ms        --   0.41     83.1     512
    decode   40.0        --      21ms   0.55       --     104
    qps  ▂▃▅▆▇█▇▆  p95 tpot  ▁▁▂▅▇▅▂▁
    ALERTS: tpot_slo_burn[decode] firing since 12:00:04 (burn 2.0)

Rendering is side-effect-free (`render()` returns a string) so tests
pin frames without a terminal; `run()` adds the clear-screen loop.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from skypilot_tpu_torch.obs import store as store_lib
from skypilot_tpu_torch.server import metrics as metrics_lib

SPARK_CHARS = ' ▁▂▃▄▅▆▇█'


def sparkline(values: List[float], width: int = 24) -> str:
    """Last `width` values as a unicode bar strip (empty input -> '')."""
    vals = [v for v in values[-width:]]
    if not vals:
        return ''
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return SPARK_CHARS[1] * len(vals)
    out = []
    for v in vals:
        idx = 1 + int((v - lo) / span * (len(SPARK_CHARS) - 2))
        out.append(SPARK_CHARS[min(idx, len(SPARK_CHARS) - 1)])
    return ''.join(out)


def _fmt_ms(seconds: Optional[float]) -> str:
    if seconds is None:
        return '--'
    return f'{seconds * 1e3:.0f}ms'


def _fmt(value: Optional[float], spec: str = '.1f') -> str:
    return '--' if value is None else format(value, spec)


def snapshot(store: store_lib.TelemetryStore, service: str,
             now: Optional[float] = None, window: float = 300.0
             ) -> Dict:
    """One frame's data: per-pool stats over ``(now-window, now]``,
    sparkline series over 4x that, and the active alert rows."""
    if now is None:
        # Anchor on the newest ingested interval, not the wall clock:
        # identical for a live fleet (they differ by < one resolution)
        # but a dead fleet's postmortem — or a sim-time store — still
        # shows its final window instead of an empty frame.
        now = store.last_t(service)
        now = time.time() if now is None else now
    t0, t1 = now - window, now
    pools = [p for p in store.pools(service, t0, t1) if p] or ['']
    rows = []
    for pool in pools:
        qfilter = pool or None
        req = store.counter_sum(service, 'skytpu_engine_requests_total',
                                t0, t1, pool=qfilter)
        if req <= 0:  # sim/LB-level feeds have no engine counter
            req = store.counter_sum(service, 'skytpu_lb_requests_total',
                                    t0, t1, pool=qfilter)
        hits = store.counter_sum(
            service, 'skytpu_engine_prefix_cache_hits_total', t0, t1,
            pool=qfilter)
        misses = store.counter_sum(
            service, 'skytpu_engine_prefix_cache_misses_total', t0, t1,
            pool=qfilter)
        lookups = hits + misses
        mfu = store.gauge_latest(service, 'skytpu_engine_mfu',
                                 pool=qfilter)
        free = store.gauge_min(service, 'skytpu_engine_kv_free_pages',
                               t0, t1, pool=qfilter)
        rows.append({
            'pool': pool or '(all)',
            'qps': req / window if req > 0 else None,
            'p95_ttft_s': store.quantile(
                service, metrics_lib.ENGINE_TTFT_FAMILY, t0, t1, 0.95,
                pool=qfilter),
            'p95_tpot_s': store.quantile(
                service, metrics_lib.ENGINE_TPOT_FAMILY, t0, t1, 0.95,
                pool=qfilter),
            'mfu': (sum(mfu.values()) / len(mfu)) if mfu else None,
            'prefix_hit_pct': (100.0 * hits / lookups)
                              if lookups > 0 else None,
            'free_pages': free,
        })
    spark_t0 = now - 4 * window
    qps_series = [v for _, v in store.series(
        service, 'skytpu_engine_requests_total', spark_t0, t1)]
    if not qps_series:
        qps_series = [v for _, v in store.series(
            service, 'skytpu_lb_requests_total', spark_t0, t1)]
    res = max(store.resolution, 1e-9)
    tpot_series: List[float] = []
    t = spark_t0
    while t < t1:  # per-interval p95 strip (one quantile per bucket)
        q = store.quantile(service, metrics_lib.ENGINE_TPOT_FAMILY,
                           t, t + res, 0.95)
        if q is not None:
            tpot_series.append(q)
        t += res
    return {
        'service': service,
        'now': now,
        'resolution': store.resolution,
        'pools': rows,
        'qps_series': qps_series,
        'tpot_series': tpot_series,
        'alerts': store.active_alerts(service),
    }


def render(snap: Dict) -> str:
    """A snapshot as the fixed-layout text frame (no cursor control —
    `run()` owns the screen, tests own the string)."""
    lines = [
        f"SERVICE {snap['service']:<24} "
        f"t={snap['now']:.0f}  (res {snap['resolution']:g}s)",
        f"{'POOL':<10}{'QPS':>8}{'p95 TTFT':>10}{'p95 TPOT':>10}"
        f"{'MFU':>7}{'PREFIX%':>9}{'FREE PG':>9}",
    ]
    for row in snap['pools']:
        lines.append(
            f"{row['pool']:<10}{_fmt(row['qps']):>8}"
            f"{_fmt_ms(row['p95_ttft_s']):>10}"
            f"{_fmt_ms(row['p95_tpot_s']):>10}"
            f"{_fmt(row['mfu'], '.2f'):>7}"
            f"{_fmt(row['prefix_hit_pct']):>9}"
            f"{_fmt(row['free_pages'], '.0f'):>9}")
    sparks = []
    if snap['qps_series']:
        sparks.append(f"qps {sparkline(snap['qps_series'])}")
    if snap['tpot_series']:
        sparks.append(f"p95 tpot {sparkline(snap['tpot_series'])}")
    if sparks:
        lines.append('  '.join(sparks))
    if snap['alerts']:
        for a in snap['alerts']:
            pool = f"[{a['pool']}]" if a['pool'] else ''
            lines.append(
                f"ALERT {a['rule']}{pool} firing since "
                f"t={a['fired_at']:.0f} (burn {a['burn']})")
    else:
        lines.append('ALERTS: none')
    return '\n'.join(lines)


def run(store: store_lib.TelemetryStore, service: Optional[str],
        interval: float = 2.0, iterations: Optional[int] = None,
        window: float = 300.0) -> int:
    """The interactive loop. iterations=None runs until Ctrl-C;
    tests pass iterations=1 for a single plain frame."""
    shown = 0
    try:
        while iterations is None or shown < iterations:
            svc = service
            if svc is None:
                known = store.services()
                svc = known[0] if known else None
            if svc is None:
                print('no telemetry yet (is a controller ingesting?)')
            else:
                frame = render(snapshot(store, svc, window=window))
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
