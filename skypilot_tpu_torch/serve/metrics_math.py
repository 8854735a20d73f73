"""Windowed histogram-quantile math over Prometheus scrapes.

The decision half of PR 5's measurement layer: the serve controller
scrapes the load balancer's federated `/metrics` (every ready replica's
engine series relabeled replica="<id>") and the SLO autoscaler needs
"p95 TTFT/TPOT over the last N seconds" from it.  Prometheus histograms
are CUMULATIVE-since-process-start, so a single scrape cannot answer
that — the windowed quantile comes from the per-bucket DELTA between
the current scrape and the scrape at (or just outside) the window edge,
exactly how `histogram_quantile(0.95, rate(..._bucket[1m]))` evaluates
server-side.

Pure math + text parsing, no I/O, no references to autoscaler state —
the unit kit in tests/test_metrics_math.py property-tests the quantile
against a reference computed from the raw samples.
"""
from __future__ import annotations

import collections
import math
import re
import time
from typing import Deque, Dict, List, Optional, Tuple

# One exposition sample line: name, optional {labels}, value.  Matches
# the renderer in server/metrics.py and ordinary Prometheus output.
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+'
    r'(-?[0-9.eE+\-]+|NaN|[+\-]Inf)\s*$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


_UNESCAPE_RE = re.compile(r'\\(.)')
_UNESCAPES = {'n': '\n', '"': '"', '\\': '\\'}


def _unescape(v: str) -> str:
    # Single left-to-right pass: sequential str.replace corrupts values
    # where an escaped backslash precedes 'n' or '"' (r'\\n' must yield
    # '\' + 'n', not a newline).
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPES.get(m.group(1), m.group(0)), v)


def parse_samples(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Exposition text -> [(family_sample_name, labels, value)].

    Unparseable lines are skipped (one replica answering garbage must
    not poison the whole decision tick — same posture as federation).
    """
    out: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        raw = m.group(3)
        if raw == 'NaN':
            continue
        if raw in ('+Inf', '-Inf'):
            value = math.inf if raw == '+Inf' else -math.inf
        else:
            try:
                value = float(raw)
            except ValueError:
                continue
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(m.group(2) or '')}
        out.append((m.group(1), labels, value))
    return out


def _le_value(raw: str) -> float:
    return math.inf if raw == '+Inf' else float(raw)


def histogram_cumulative(
        samples: List[Tuple[str, Dict[str, str], float]],
        family: str) -> Dict[float, float]:
    """Aggregate every `<family>_bucket` series (all label sets — i.e.
    summed across replicas) into one cumulative {le_bound: count} map.

    Cross-replica summing is sound only because the registry pins one
    fixed bucket set per family (metrics.py _BUCKETS); series missing a
    bound simply contribute nothing to it.
    """
    bucket_name = family + '_bucket'
    agg: Dict[float, float] = {}
    for name, labels, value in samples:
        if name != bucket_name or 'le' not in labels:
            continue
        try:
            le = _le_value(labels['le'])
        except ValueError:
            continue
        agg[le] = agg.get(le, 0.0) + value
    return agg


def histogram_cumulative_by_series(
        samples: List[Tuple[str, Dict[str, str], float]],
        family: str) -> Dict[tuple, Dict[float, float]]:
    """Like histogram_cumulative but keyed by series — the label set
    minus 'le', i.e. one entry per replica under federation.  Per-series
    maps are what reset detection must run on: a SUMMED map goes
    backward whenever any one replica restarts or leaves the scrape,
    which would clear the whole window on every churn event."""
    bucket_name = family + '_bucket'
    out: Dict[tuple, Dict[float, float]] = {}
    for name, labels, value in samples:
        if name != bucket_name or 'le' not in labels:
            continue
        try:
            le = _le_value(labels['le'])
        except ValueError:
            continue
        key = tuple(sorted((k, v) for k, v in labels.items()
                           if k != 'le'))
        series = out.setdefault(key, {})
        series[le] = series.get(le, 0.0) + value
    return out


def gauge_total(samples: List[Tuple[str, Dict[str, str], float]],
                family: str) -> float:
    """Sum of every series of a gauge family (e.g. the whole service's
    queued-prefill-token backlog across replica labels)."""
    return sum(v for name, _, v in samples
               if name == family and math.isfinite(v))


def counter_total(samples: List[Tuple[str, Dict[str, str], float]],
                  family: str, **label_match: str) -> float:
    """Sum of a counter family's series whose labels carry every given
    (key, value) pair."""
    total = 0.0
    for name, labels, value in samples:
        if name != family or not math.isfinite(value):
            continue
        if all(labels.get(k) == v for k, v in label_match.items()):
            total += value
    return total


def quantile_from_cumulative(cum: Dict[float, float],
                             q: float) -> Optional[float]:
    """histogram_quantile over one cumulative {le: count} map.

    Linear interpolation inside the bucket the q-rank falls in (from the
    previous finite bound, 0 below the first), Prometheus semantics:
    a rank landing in the +Inf bucket returns the largest FINITE bound —
    the data says "worse than everything we can resolve", and for
    SLO comparison that clamp is the honest answer (the caller compares
    it >= target, and every real target lives inside the finite range).
    None when the histogram holds no observations.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f'quantile must be in [0, 1], got {q}')
    bounds = sorted(cum)
    if not bounds:
        return None
    # The largest bound's cumulative count is the total: normally the
    # +Inf bucket, or the last finite bound on truncated foreign input
    # (our renderer always emits +Inf).
    total = cum[bounds[-1]]
    if total <= 0:
        return None
    rank = q * total
    prev_bound, prev_count = 0.0, 0.0
    for b in bounds:
        count = cum[b]
        if count >= rank:
            if math.isinf(b):
                finite = [x for x in bounds if math.isfinite(x)]
                return finite[-1] if finite else None
            if count <= prev_count:
                return b
            frac = (rank - prev_count) / (count - prev_count)
            return prev_bound + (b - prev_bound) * frac
        prev_bound, prev_count = b, count
    finite = [x for x in bounds if math.isfinite(x)]
    return finite[-1] if finite else None


class WindowedHistogram:
    """Windowed quantiles from successive cumulative-histogram scrapes.

    record() successive {le: cumulative_count} snapshots; quantile(q)
    answers over the observations that arrived INSIDE the window — the
    per-bucket delta between the newest snapshot and the one at (or just
    outside) the window edge, the same retention rule as the
    autoscaler's QPS counter sampling.

    Counter resets (a replica restart zeroes its histograms, so the
    summed cumulative counts can go BACKWARD) are clamped: a snapshot
    with any bucket below the previous one starts a fresh baseline —
    one window of partial vision beats a negative bucket delta.
    """

    def __init__(self, window_seconds: float) -> None:
        self.window_seconds = window_seconds
        self._snaps: Deque[Tuple[float, Dict[float, float]]] = \
            collections.deque()

    def record(self, cum: Dict[float, float],
               now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        if self._snaps:
            last = self._snaps[-1][1]
            if any(cum.get(le, 0.0) < count - 1e-9
                   for le, count in last.items()):
                self._snaps.clear()
        self._snaps.append((now, dict(cum)))
        cutoff = now - self.window_seconds
        while len(self._snaps) >= 2 and self._snaps[1][0] <= cutoff:
            self._snaps.popleft()

    def window_delta(self,
                     now: Optional[float] = None) -> Dict[float, float]:
        """Cumulative {le: count} of observations inside the window.

        With `now` given, a newest snapshot older than the window means
        the scrape source went dark — the data describes a PAST window,
        not this one, and answering from it would freeze decisions on
        stale latency.  Empty in that case (callers fall back to their
        no-samples path)."""
        if len(self._snaps) < 2:
            return {}
        if now is not None and \
                now - self._snaps[-1][0] > self.window_seconds:
            return {}
        base, cur = self._snaps[0][1], self._snaps[-1][1]
        return {le: max(0.0, count - base.get(le, 0.0))
                for le, count in cur.items()}

    def sample_count(self, now: Optional[float] = None) -> float:
        """Observations inside the window (the +Inf bucket delta)."""
        delta = self.window_delta(now)
        if not delta:
            return 0.0
        return delta[max(delta)]

    def quantile(self, q: float,
                 now: Optional[float] = None) -> Optional[float]:
        return quantile_from_cumulative(self.window_delta(now), q)


class FederatedWindowedHistogram:
    """Windowed quantiles over a FEDERATED family: one WindowedHistogram
    per series (replica label set), summed at read time.

    Summing before windowing is not churn-safe: one replica restarting
    or dropping out of the scrape makes the summed cumulative counts go
    backward — clearing the WHOLE window every tick under a flapping
    replica (silent degradation to QPS scaling) — and a replica
    REJOINING after such a clear injects its entire since-boot counts
    into the delta.  Per-series windows confine both effects to the one
    replica: its first post-(re)join snapshot is just a baseline, and a
    series unseen for a full window is dropped."""

    def __init__(self, window_seconds: float) -> None:
        self.window_seconds = window_seconds
        self._series: Dict[tuple, WindowedHistogram] = {}
        self._last_seen: Dict[tuple, float] = {}

    def record(self, by_series: Dict[tuple, Dict[float, float]],
               now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for key, cum in by_series.items():
            w = self._series.get(key)
            if w is None:
                w = self._series[key] = WindowedHistogram(
                    self.window_seconds)
            w.record(cum, now)
            self._last_seen[key] = now
        for key in [k for k, seen in self._last_seen.items()
                    if now - seen > self.window_seconds]:
            del self._series[key]
            del self._last_seen[key]

    def window_delta(self,
                     now: Optional[float] = None) -> Dict[float, float]:
        total: Dict[float, float] = {}
        for w in self._series.values():
            for le, count in w.window_delta(now).items():
                total[le] = total.get(le, 0.0) + count
        return total

    def sample_count(self, now: Optional[float] = None) -> float:
        delta = self.window_delta(now)
        if not delta:
            return 0.0
        return delta[max(delta)]

    def quantile(self, q: float,
                 now: Optional[float] = None) -> Optional[float]:
        return quantile_from_cumulative(self.window_delta(now), q)

    def adopt(self, old: 'FederatedWindowedHistogram') -> None:
        """Carry another instance's series over (serve-update rebuild)."""
        self._series.update(old._series)
        self._last_seen.update(old._last_seen)
