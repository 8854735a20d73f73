"""Load-balancing policies (capability parity:
sky/serve/load_balancing_policies.py — round_robin :85, least_load :111).

A policy picks a replica URL from the ready set; the load balancer calls
`select` per request, reports start/completion (with wall time) so
least_load can track outstanding requests and per-replica latency, and
feeds it each replica's engine backlog as it learns it (response
headers + federated scrapes), so a replica grinding through a chunked
long prefill stops receiving short requests it would delay.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

# A backlog/latency observation older than this says nothing about the
# replica NOW (several controller ticks / scrape periods).  Shared with
# the load balancer's admission control: routing and shedding must
# agree on which observations are trustworthy.
BACKLOG_STALENESS_SECONDS = 10.0


class LoadBalancingPolicy:
    NAME = 'abstract'

    def select(self, ready_urls: List[str]) -> Optional[str]:
        raise NotImplementedError

    def on_request_start(self, url: str) -> None:
        pass

    def on_request_end(self, url: str,
                       duration_s: Optional[float] = None) -> None:
        pass

    def update_load(self, url: str, queued_tokens: float,
                    now: Optional[float] = None) -> None:
        """Feed one replica's engine backlog observation (queued prefill
        tokens).  Policies that route blind ignore it."""
        del url, queued_tokens, now

    def prune(self, keep_urls) -> None:
        """Drop state for replicas that left the ready set: autoscaling
        churn mints a fresh URL per replica, and unpruned maps grow for
        the LB's whole lifetime.  Stateless policies have nothing to
        drop."""
        del keep_urls

    def snapshot(self, url: str) -> Dict[str, float]:
        """The per-replica signals this policy ranks on, for the
        routing-decision trace span (lb.route): what the policy KNEW
        when it chose.  Blind policies know nothing."""
        del url
        return {}

    def clone(self) -> 'LoadBalancingPolicy':
        """Fresh instance of this policy class (no shared state).  The
        load balancer ranks the DECODE pool's handoff candidates with
        a clone of its routing policy, so decode-target picks see
        decode-pool load without perturbing prefill-pool state."""
        return type(self)()

    @staticmethod
    def make(name: str) -> 'LoadBalancingPolicy':
        impl = _POLICIES.get(name)
        if impl is None:
            raise ValueError(f'unknown load_balancing_policy {name!r}; '
                             f'choose from {sorted(_POLICIES)}')
        return impl()


class RoundRobinPolicy(LoadBalancingPolicy):
    NAME = 'round_robin'

    def __init__(self) -> None:
        self._counter = itertools.count()

    def select(self, ready_urls: List[str]) -> Optional[str]:
        if not ready_urls:
            return None
        return ready_urls[next(self._counter) % len(ready_urls)]


class LeastLoadPolicy(LoadBalancingPolicy):
    """Latency-aware least-load routing.

    Ranks the READY replicas by (engine backlog + outstanding proxied
    requests, EWMA request latency, round-robin rotation) and picks the
    minimum:

    - **backlog**: the replica's queued-prefill-token gauge as last
      reported through the LB (completion response headers and the
      federated /metrics scrape).  An observation older than
      STALENESS_SECONDS — replica restarted, scrape path down —
      contributes 0 rather than a stale verdict.
    - **outstanding**: requests this LB has in flight to the replica —
      the load the gauges cannot see yet.  With every gauge stale or
      missing the rank degrades to classic outstanding-count
      least-load.
    - **rotation**: the deterministic tie-break is a round-robin cursor
      (not "always the first URL"), so a fully-blind policy — no
      gauges, nothing outstanding — degrades to exactly round_robin
      instead of hammering one replica.

    Only URLs in `ready_urls` are ever considered — state remembered
    for a replica that dropped out of the ready set (NOT_READY,
    draining) cannot get it selected.
    """
    NAME = 'least_load'

    STALENESS_SECONDS = BACKLOG_STALENESS_SECONDS
    # EWMA smoothing for per-replica request latency.
    _EWMA_ALPHA = 0.3
    # Queued prefill tokens that weigh like one outstanding request in
    # the load rank: backlog is in TOKENS, outstanding in REQUESTS, and
    # summing them raw would let any token backlog swamp real in-flight
    # decode work (which the prefill gauge cannot see).  A nominal
    # request is a few hundred prompt tokens.
    TOKENS_PER_REQUEST_EQUIV = 256.0

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._outstanding: Dict[str, int] = {}
        # url -> (queued_tokens, monotonic time observed)
        self._backlog: Dict[str, Tuple[float, float]] = {}
        # url -> (ewma latency seconds, monotonic time observed)
        self._ewma_latency: Dict[str, Tuple[float, float]] = {}
        self._rotation = itertools.count()

    def select(self, ready_urls: List[str]) -> Optional[str]:
        if not ready_urls:
            return None
        now = time.monotonic()
        offset = next(self._rotation)
        with self._lock:
            def rank(i_url):
                i, url = i_url
                tokens, seen = self._backlog.get(url, (0.0, -1e18))
                fresh = now - seen <= self.STALENESS_SECONDS
                backlog = tokens if fresh else 0.0
                ewma, ewma_at = self._ewma_latency.get(url, (0.0, -1e18))
                # A stale EWMA ranks as unknown: without expiry, one
                # slow request would starve its replica forever under
                # sequential traffic (never selected -> never updated).
                if now - ewma_at > self.STALENESS_SECONDS:
                    ewma = 0.0
                return (backlog / self.TOKENS_PER_REQUEST_EQUIV +
                        self._outstanding.get(url, 0),
                        ewma,
                        (i - offset) % len(ready_urls))
            return min(enumerate(ready_urls), key=rank)[1]

    def on_request_start(self, url: str) -> None:
        with self._lock:
            self._outstanding[url] = self._outstanding.get(url, 0) + 1

    def on_request_end(self, url: str,
                       duration_s: Optional[float] = None) -> None:
        with self._lock:
            n = self._outstanding.get(url, 0)
            if n <= 1:
                self._outstanding.pop(url, None)
            else:
                self._outstanding[url] = n - 1
            if duration_s is not None:
                prev = self._ewma_latency.get(url)
                now = time.monotonic()
                if prev is None or \
                        now - prev[1] > self.STALENESS_SECONDS:
                    self._ewma_latency[url] = (duration_s, now)
                else:
                    self._ewma_latency[url] = (
                        self._EWMA_ALPHA * duration_s +
                        (1 - self._EWMA_ALPHA) * prev[0], now)

    def update_load(self, url: str, queued_tokens: float,
                    now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._backlog[url] = (max(0.0, queued_tokens), now)

    def snapshot(self, url: str) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {
                'outstanding': self._outstanding.get(url, 0)}
            if url in self._backlog:
                out['backlog_tokens'] = self._backlog[url][0]
            if url in self._ewma_latency:
                out['latency_ewma_s'] = round(
                    self._ewma_latency[url][0], 6)
            return out

    def prune(self, keep_urls) -> None:
        keep = set(keep_urls)
        with self._lock:
            # _outstanding is deliberately NOT pruned: its entries only
            # exist while requests are in flight (start/end balance),
            # so it cannot leak — and wiping it on a transient
            # readiness blip would rank a still-busy replica as idle
            # the moment it returns.
            for state in (self._backlog, self._ewma_latency):
                for url in [u for u in state if u not in keep]:
                    del state[url]


class InstanceAwarePolicy(LeastLoadPolicy):
    """Least-load weighted by replica capacity (reference :151 weights by
    instance size; here every TPU replica of one service has the same
    slice shape, so this degenerates to least_load — kept as its own name
    for spec parity)."""
    NAME = 'instance_aware'


_POLICIES = {
    p.NAME: p
    for p in (RoundRobinPolicy, LeastLoadPolicy, InstanceAwarePolicy)
}
