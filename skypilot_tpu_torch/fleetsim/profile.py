"""Per-run control-plane profile: which hot path to fix next.

A fleet run's deliverable is not just the headline (req/s, replicas,
recovery time) — it is the RANKED list of where the control plane
spent its wall time getting there.  Every database operation is
already timed into ``skytpu_db_op_seconds`` (utils/db_utils.py) and
every simulator-driven control step into
``skytpu_fleetsim_control_seconds``; this module snapshots the shared
registry around a run and diffs the two expositions, so the report
survives the registry being global and cumulative (other runs, other
tests — only this run's delta counts).

Report rows are ``{'path', 'seconds', 'calls', 'mean_ms'}``, ranked
by total seconds descending: ``db.transaction[sqlite]`` above
``fleetsim.autoscaler.evaluate`` means the state backend, not the
decision logic, is the next thing to make event-driven.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from skypilot_tpu_torch.server import metrics as metrics_lib

# Histogram families folded into the report, with the label(s) that
# name the hot path.
_DB_FAMILY = 'skytpu_db_op_seconds'
_SIM_FAMILY = 'skytpu_fleetsim_control_seconds'
# The ready-view cache counter rides along as zero-cost rows
# (cache.ready_view[hit] / [miss]): BENCH_r07's #1 hot path was
# replicas.ready_view re-querying the full table every tick, and the
# hit/miss split is the per-run proof the cache is doing the work.
_CACHE_FAMILY = 'skytpu_serve_ready_view_cache_total'


def snapshot() -> str:
    """The shared registry's exposition text, verbatim."""
    return metrics_lib.render()


def _path_key(name: str, labels: Dict[str, str]) -> Tuple[str, str]:
    """(path, which-of-sum/count) for one exposition sample, or
    ('', '') when the sample is not a profiled family."""
    if name == _CACHE_FAMILY:
        return (f'cache.ready_view[{labels.get("result", "?")}]',
                '_count')
    for family, fmt in ((_DB_FAMILY, 'db'), (_SIM_FAMILY, 'fleetsim')):
        for suffix in ('_sum', '_count'):
            if name != family + suffix:
                continue
            if fmt == 'db':
                path = (f'db.{labels.get("op", "?")}'
                        f'[{labels.get("backend", "?")}]')
            else:
                path = f'fleetsim.{labels.get("path", "?")}'
            return path, suffix
    return '', ''


def _totals(text: str) -> Tuple[Dict[str, float], Dict[str, float]]:
    from skypilot_tpu_torch.serve import metrics_math
    sums: Dict[str, float] = {}
    counts: Dict[str, float] = {}
    for name, labels, value in metrics_math.parse_samples(text):
        path, suffix = _path_key(name, labels)
        if not path:
            continue
        bucket = sums if suffix == '_sum' else counts
        bucket[path] = bucket.get(path, 0.0) + value
    return sums, counts


def diff(before: str, after: str) -> List[Dict[str, Any]]:
    """Rank the control-plane paths by wall seconds spent BETWEEN the
    two snapshots (both from :func:`snapshot`)."""
    b_sums, b_counts = _totals(before)
    a_sums, a_counts = _totals(after)
    rows: List[Dict[str, Any]] = []
    # Union: counter-only paths (cache.ready_view[...]) have counts but
    # no seconds — they must still rank (at 0.0s, i.e. the bottom).
    for path in set(a_sums) | set(a_counts):
        seconds = a_sums.get(path, 0.0) - b_sums.get(path, 0.0)
        calls = a_counts.get(path, 0.0) - b_counts.get(path, 0.0)
        if calls <= 0 and seconds <= 0:
            continue
        rows.append({
            'path': path,
            'seconds': round(seconds, 6),
            'calls': int(calls),
            'mean_ms': (round(1e3 * seconds / calls, 4)
                        if calls > 0 else None),
        })
    rows.sort(key=lambda r: (-r['seconds'], r['path']))
    return rows


def top(report: List[Dict[str, Any]], n: int = 3) -> List[str]:
    """The top-n hot-path names — the run's 'fix this next' answer."""
    return [row['path'] for row in report[:n]]


def render_report(report: List[Dict[str, Any]],
                  limit: int = 12) -> str:
    """Human-readable ranking for the CLI."""
    lines = [f'{"control-plane path":<40} {"seconds":>10} '
             f'{"calls":>9} {"mean ms":>9}']
    for row in report[:limit]:
        mean = ('-' if row['mean_ms'] is None
                else f'{row["mean_ms"]:.3f}')
        lines.append(f'{row["path"]:<40} {row["seconds"]:>10.3f} '
                     f'{row["calls"]:>9d} {mean:>9}')
    if len(report) > limit:
        lines.append(f'... {len(report) - limit} more path(s)')
    return '\n'.join(lines)
