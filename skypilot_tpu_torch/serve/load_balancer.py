"""HTTP load balancer: reverse proxy in front of a service's replicas
(capability parity: sky/serve/load_balancer.py:24).

One LB per service, running an aiohttp server on its own thread + event
loop so it works identically library-direct and inside the API server.

Observability: every proxied request lands in the shared Prometheus
registry (skytpu_lb_requests_total by replica/status code, per-replica
duration histograms); the autoscaler estimates QPS from the same request
counter instead of keeping a parallel timestamp trace.  GET /metrics on
the LB is handled locally and FEDERATES: it scrapes each ready replica's
/metrics and re-exports those series relabeled with replica="<id>", so
one scrape observes the whole service (engine TTFT/TPOT histograms
included).

Request tracing: the LB is where a request's distributed trace BEGINS —
it honors the client's `X-Skytpu-Request-Id` or mints one at admission,
records admission/routing-decision/proxy/shed span events into the
process's always-on flight recorder (server/tracing.py), and forwards
the id to the replica so the engine's span events share the key.  GET
/debug/requests[/<id>] on the LB FEDERATES: it merges its own recorder
events with each ready replica's /debug view (the same pattern as the
/metrics federation), so one query shows LB admission + routing + the
engine's queue/prefill-chunk/first-token decomposition end to end.

Disaggregated prefill/decode (pool-aware routing): replica managers
stamp a role on every replica; when the ready set contains BOTH a
prefill and a decode pool, proxied requests route into the PREFILL
pool and the LB picks decode candidates from the decode pool's ready
set (ranked by a second instance of the routing policy), stamping them
on the forwarded request as `X-Skytpu-Decode-Url` — the prefill
replica pushes the request's KV pages to the first candidate that
accepts (inference/kv_transfer.py) and relays its completion.
Prefill-backlog shedding consults only the prefill pool: decode
replicas never queue prefill tokens, so counting them would fail the
admission check open forever.  With either pool empty the LB degrades
to routing over whatever is ready (every replica runs the full
engine), so pool bring-up and preemption churn never 503 servable
requests.

Queue-aware admission control: the LB keeps a per-replica view of the
engine's queued-prefill-token backlog — updated for free from the
X-Skytpu-Queued-Prefill-Tokens header replicas attach to every proxied
response, refreshed by each federated /metrics scrape — and, behind the
`max_queue_tokens_per_replica` spec knob, sheds with 429 + a
drain-rate-derived Retry-After BEFORE the replicas saturate (the legacy
behavior shed only at zero ready replicas, after every queue was
already minutes deep).  Shed requests still count in the LB's demand
counter, so the autoscaler sees the suppressed demand and keeps scaling
up while admission control protects latency.  The same backlog view
feeds the least_load policy's latency-aware ranking.
"""
from __future__ import annotations

import asyncio
import math
import threading
import time
import urllib.parse
from typing import Callable, List, Optional, Tuple

import aiohttp
from aiohttp import web

from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.serve.load_balancing_policies import (
    BACKLOG_STALENESS_SECONDS, LoadBalancingPolicy)
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing

logger = sky_logging.init_logger(__name__)

_HOP_HEADERS = {'connection', 'keep-alive', 'transfer-encoding', 'host',
                'proxy-authenticate', 'proxy-authorization', 'te',
                'trailers', 'upgrade'}
# Per-replica /metrics scrape budget for one federated LB scrape.
_FEDERATE_TIMEOUT_SECONDS = 2.0
# Advisory client back-off when no replica is ready (matches the
# controller tick that could bring one up).
_RETRY_AFTER_SECONDS = 5
# Upstream proxy bounds: no TOTAL deadline (streaming completions run
# for minutes legitimately), but a replica that goes silent this long
# mid-response is dead — fail the proxy call 502 so the client can
# retry instead of hanging forever on a wedged socket.  The bound
# comfortably exceeds the worst legitimate first-byte gap (a chunked
# 128k prefill on a saturated engine; TTFT buckets extend to 120 s).
_UPSTREAM_CONNECT_TIMEOUT_SECONDS = 10.0
_UPSTREAM_IDLE_TIMEOUT_SECONDS = 300.0
# Engine backlog header replicas attach to proxied responses
# (inference/server.py): queued prefill tokens, read here for free on
# the response path — no extra round trip.
BACKLOG_HEADER = metrics_lib.BACKLOG_HEADER
# Retry-After bounds for queue-aware sheds (finite and honest: long
# enough to matter, short enough that clients re-offer while the
# autoscaler's scale-up is still warming).
_SHED_RETRY_AFTER_MAX_SECONDS = 60
# While shedding, no responses flow, so backlog headers cannot refresh
# the admission view; the LB re-scrapes the replicas' /metrics itself,
# at most this often, so draining queues re-open admission promptly
# (waiting out the full staleness window would wedge-then-burst).
_BACKLOG_REFRESH_INTERVAL_SECONDS = 1.0
# The no-ready 503 Retry-After derives from the drain-rate EWMA (like
# the 429 shed path) only while the last backlog observation is this
# fresh — replica churn prunes the per-replica view, so this single
# retained observation is all the 503 path has to reason from.
_NO_READY_BACKLOG_MAX_AGE_SECONDS = 30.0
# Decode candidates stamped per handoff: primary + one fallback — the
# prefill replica re-routes the payload to the fallback when the
# primary dies mid-push (no re-prefill).
_DECODE_CANDIDATES = 2


class LoadBalancer:

    def __init__(self, service_name: str, port: int,
                 policy: LoadBalancingPolicy,
                 ready_urls_fn: Callable[[], List[str]],
                 ready_replicas_fn: Optional[
                     Callable[[], List[Tuple[int, str]]]] = None,
                 max_queue_tokens_per_replica: Optional[int] = None
                 ) -> None:
        self.service_name = service_name
        self.port = port
        # The policy setter also mints the decode-pool twin, so a
        # `serve update` policy swap replaces both.
        self.policy = policy
        # Queue-aware shedding knob (service_spec
        # max_queue_tokens_per_replica; None = legacy behavior, shed
        # only at zero ready replicas).  Public: `serve update` swaps it.
        self.max_queue_tokens_per_replica = max_queue_tokens_per_replica
        self._ready_urls_fn = ready_urls_fn
        # Optional richer view: [(replica_id, url)].  Used to label
        # per-replica series and to federate /metrics; without it the
        # replica label falls back to the url.
        self._ready_replicas_fn = ready_replicas_fn
        # Monotonic proxied-request count (mirrors the
        # skytpu_lb_requests_total family).  The autoscaler samples this
        # instead of a parallel timestamp deque.  Shed requests COUNT:
        # suppressed demand must stay visible to scaling.
        self._request_count = 0
        # url -> (queued prefill tokens, monotonic observed-at).  Only
        # touched on the LB's own event loop (response path + federated
        # scrape), so no lock.
        self._backlog: dict = {}
        # Latest single backlog observation, retained across ready-set
        # pruning: the no-ready 503 path derives its Retry-After from
        # it after the per-replica view is gone.
        self._last_backlog_obs: Optional[Tuple[float, float]] = None
        # url -> replica role ('prefill' / 'decode' / anything else =
        # monolithic), from the ready-replicas view.
        self._roles: dict = {}
        self._last_ready_set: frozenset = frozenset()
        # EWMA of observed backlog drain (tokens/sec across the
        # service), the basis of the shed Retry-After.
        self._drain_rate_tok_s: Optional[float] = None
        # Self-refresh bookkeeping (LB event loop only): last kick time
        # and an in-flight guard, rate-limiting the shed-path re-scrape.
        self._backlog_refresh_at = -1e18
        self._backlog_refreshing = False
        # url -> monotonic time of the last SUCCESSFUL /metrics scrape
        # of that replica, feeding the skytpu_lb_scrape_age_seconds
        # gauge: when the SLO autoscaler decides on a stale federated
        # window (dark scrape expiry, PR 9), dashboards can now see it.
        self._scrape_ok_at: dict = {}
        # url -> monotonic time it entered the ready set: the age
        # baseline for a replica with no successful scrape yet.
        self._ready_since: dict = {}
        # url -> replica label the age gauge was last exported under,
        # so a departed replica's gauge can be removed (a stale age
        # series would read as a permanently-dark replica).
        self._scrape_age_labels: dict = {}
        self._started_mono = time.monotonic()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._runner: Optional[web.AppRunner] = None
        # One pooled session for the proxy hot path, created on the LB's
        # own event loop and closed in stop().
        self._session: Optional[aiohttp.ClientSession] = None

    @property
    def policy(self) -> LoadBalancingPolicy:
        return self._policy

    @policy.setter
    def policy(self, policy: LoadBalancingPolicy) -> None:
        """Install a routing policy plus its decode-pool twin: a
        SECOND instance of the same class ranking KV-handoff decode
        candidates, so decode-target picks track decode-pool load
        without perturbing the prefill pool's rotation/outstanding
        state."""
        self._policy = policy
        self._decode_policy = policy.clone()

    # ----- observability ------------------------------------------------------
    def proxied_requests(self) -> int:
        """Total requests proxied (including rejected 503s): the
        autoscaler's QPS source."""
        return self._request_count

    def _ready(self) -> Tuple[List[str], dict]:
        """One state read per request: (urls, url -> replica label).
        On a ready-set change, per-replica state for departed URLs is
        pruned (autoscaling churn mints a fresh URL per replica; the
        maps would otherwise grow for the LB's lifetime)."""
        if self._ready_replicas_fn is not None:
            pairs = self._ready_replicas_fn()
            urls, labels, roles = [], {}, {}
            for pair in pairs:
                # (replica_id, url) or (replica_id, url, role) — the
                # role stamp arrived with disaggregated pools; plain
                # services keep the 2-tuple shape.
                rid, url = pair[0], pair[1]
                urls.append(url)
                labels[url] = str(rid)
                if len(pair) > 2 and pair[2]:
                    roles[url] = str(pair[2])
            self._roles = roles
        else:
            urls, labels = self._ready_urls_fn(), {}
            self._roles = {}
        current = frozenset(urls)
        if current != self._last_ready_set:
            joined = current - self._last_ready_set
            self._last_ready_set = current
            now = time.monotonic()
            for u in current:
                # Age baseline for a replica never successfully scraped
                # is its JOIN time — a fresh replica must not inherit
                # the LB's whole uptime as its "dark" age.
                self._ready_since.setdefault(u, now)
            for u in joined:
                # Readmission re-baseline: a replica that flapped
                # ready -> notready -> ready comes back "dark since
                # rejoin" — its previous incarnation's scrape success
                # must not vouch for (or age-penalize) the new one.
                self._ready_since[u] = now
                self._scrape_ok_at.pop(u, None)
            for stale in [u for u in self._backlog if u not in current]:
                del self._backlog[stale]
            for stale in [u for u in self._ready_since
                          if u not in current]:
                del self._ready_since[stale]
            for stale in [u for u in self._scrape_ok_at
                          if u not in current]:
                del self._scrape_ok_at[stale]
            for stale in [u for u in self._scrape_age_labels
                          if u not in current]:
                metrics_lib.remove_gauge(
                    'skytpu_lb_scrape_age_seconds',
                    service=self.service_name,
                    replica=self._scrape_age_labels.pop(stale))
            self.policy.prune(current)
            self._decode_policy.prune(current)
        return urls, labels

    # ----- queue-aware admission ----------------------------------------------
    def _note_backlog(self, url: str, tokens: float) -> None:
        """Fold one replica backlog observation into the admission view
        and the routing policy; successive decreases feed the drain-rate
        EWMA the shed Retry-After is derived from."""
        now = time.monotonic()
        prev = self._backlog.get(url)
        if prev is not None:
            prev_tokens, prev_t = prev
            dt = now - prev_t
            if dt > 1e-3 and tokens < prev_tokens:
                rate = (prev_tokens - tokens) / dt
                self._drain_rate_tok_s = rate \
                    if self._drain_rate_tok_s is None \
                    else 0.3 * rate + 0.7 * self._drain_rate_tok_s
        self._backlog[url] = (max(0.0, tokens), now)
        self._last_backlog_obs = (max(0.0, tokens), now)
        self.policy.update_load(url, tokens, now)
        self._decode_policy.update_load(url, tokens, now)

    def _shed_excess_tokens(self, urls: List[str]) -> Optional[float]:
        """Tokens above the per-replica limit on the LEAST loaded
        replica, when admission control says shed; None to admit.

        Sheds only when EVERY ready replica has a FRESH over-limit
        backlog observation: a replica with no (or stale) data might
        have capacity, and shedding a servable request is the worse
        error (fail open).
        """
        limit = self.max_queue_tokens_per_replica
        if limit is None or not urls:
            return None
        now = time.monotonic()
        fresh = []
        for url in urls:
            obs = self._backlog.get(url)
            if obs is None or now - obs[1] > BACKLOG_STALENESS_SECONDS:
                return None
            fresh.append(obs[0])
        least = min(fresh)
        if least < limit:
            return None
        return least - limit

    def _kick_backlog_refresh(self, urls: List[str]) -> None:
        """Fire-and-forget re-scrape of the replicas' /metrics backlog
        gauges, rate-limited to one in flight per
        _BACKLOG_REFRESH_INTERVAL_SECONDS.  Called from the shed path:
        while every request is shed, nothing else refreshes the
        admission view, and without this the LB would hold 429s for the
        whole staleness window after the queues drained, then fail open
        into a burst."""
        now = time.monotonic()
        if self._backlog_refreshing or \
                now - self._backlog_refresh_at < \
                _BACKLOG_REFRESH_INTERVAL_SECONDS:
            return
        self._backlog_refreshing = True
        self._backlog_refresh_at = now

        async def refresh():
            try:
                async def one(url):
                    try:
                        assert self._session is not None
                        async with self._session.get(
                                url.rstrip('/') + '/metrics',
                                timeout=aiohttp.ClientTimeout(
                                    total=_FEDERATE_TIMEOUT_SECONDS)
                        ) as resp:
                            if resp.status == 200:
                                self._scrape_ok_at[url] = \
                                    time.monotonic()
                                self._note_backlog_from_exposition(
                                    url, await resp.text())
                    except (aiohttp.ClientError, asyncio.TimeoutError,
                            OSError):
                        pass
                await asyncio.gather(*(one(u) for u in urls))
            finally:
                self._backlog_refreshing = False

        asyncio.ensure_future(refresh())

    def _note_backlog_from_exposition(self, url: str, text: str) -> None:
        """Refresh one replica's backlog from its scraped /metrics — the
        path that unblocks shedding: while the LB sheds, no responses
        flow, so response headers alone would leave the over-limit view
        frozen until staleness."""
        from skypilot_tpu_torch.serve import metrics_math
        samples = metrics_math.parse_samples(text)
        found = [v for name, _, v in samples
                 if name == metrics_lib.QUEUED_PREFILL_TOKENS_FAMILY]
        if found:
            self._note_backlog(url, sum(found))

    def _shed_retry_after(self, excess_tokens: float) -> int:
        """Seconds until the least-loaded replica's backlog should be
        back under the limit, from the observed drain rate; a finite
        integer always (RFC 7231 delta-seconds)."""
        rate = self._drain_rate_tok_s
        if rate is None or rate <= 0:
            return _RETRY_AFTER_SECONDS
        return int(min(_SHED_RETRY_AFTER_MAX_SECONDS,
                       max(1, math.ceil(excess_tokens / rate))))

    def _no_ready_retry_after(self) -> int:
        """503 back-off, derived like the 429 shed path: how long the
        last-known engine backlog takes to drain at the observed rate
        — replicas mid-churn (NOT_READY blip, rolling update) come
        back roughly when their queues clear, so this beats the static
        constant whenever the EWMA is warm.  Falls back to the
        constant when the EWMA or the retained backlog observation is
        cold (fresh LB, long outage)."""
        rate = self._drain_rate_tok_s
        obs = self._last_backlog_obs
        if rate is None or rate <= 0 or obs is None:
            return _RETRY_AFTER_SECONDS
        tokens, seen = obs
        if time.monotonic() - seen > _NO_READY_BACKLOG_MAX_AGE_SECONDS \
                or tokens <= 0:
            return _RETRY_AFTER_SECONDS
        return int(min(_SHED_RETRY_AFTER_MAX_SECONDS,
                       max(1, math.ceil(tokens / rate))))

    def _pick_decode_targets(self, decode_urls: List[str]) -> List[str]:
        """Decode-pool candidates for one KV handoff: the decode
        policy's pick first, then distinct fallbacks in ready order —
        the prefill replica walks the list, so a dead primary costs
        one bounded push attempt, not a re-prefill."""
        primary = self._decode_policy.select(decode_urls)
        targets = [primary] if primary else []
        for u in decode_urls:
            if len(targets) >= _DECODE_CANDIDATES:
                break
            if u not in targets:
                targets.append(u)
        return targets

    # ----- data plane ---------------------------------------------------------
    async def _handle(self, request: web.Request) -> web.StreamResponse:
        self._request_count += 1
        # Trace begins here: honor the client's request id or mint one
        # (stamped on EVERY outcome below, so a shed/503 caller still
        # has an id to `skytpu trace` the decision with).
        rid = request.headers.get(tracing.TRACE_HEADER) or \
            tracing.mint_request_id()
        t_admit = time.perf_counter()
        tracing.record_instant(rid, 'lb.admission', t_admit,
                               service=self.service_name,
                               path=str(request.rel_url))
        urls, labels = self._ready()
        # Disaggregated pools: with both a prefill and a decode pool
        # ready, traffic enters through the PREFILL pool and the LB
        # names decode candidates for the KV handoff.  Admission
        # control consults only the prefill pool's backlog — decode
        # replicas never queue prefill tokens, and folding their
        # always-zero gauges in would fail the every-replica-over-
        # limit check open forever.
        prefill_urls = [u for u in urls
                        if self._roles.get(u) == 'prefill']
        decode_urls = [u for u in urls
                       if self._roles.get(u) == 'decode']
        disagg = bool(prefill_urls) and bool(decode_urls)
        route_urls = prefill_urls if disagg else urls
        excess = self._shed_excess_tokens(
            prefill_urls if prefill_urls else urls)
        if excess is not None:
            # Queue-aware shed: every ready replica's engine backlog is
            # at/over the limit — 429 now beats joining a queue that
            # already violates the SLO.  Own counter (no replica label:
            # the request never reached one), and the request already
            # counted in _request_count above, so the autoscaler still
            # sees the suppressed demand and keeps scaling up.
            retry_after = self._shed_retry_after(excess)
            # While shedding, response headers stop flowing: keep the
            # admission view current ourselves.
            self._kick_backlog_refresh(urls)
            metrics_lib.inc_counter('skytpu_lb_shed_total',
                                    service=self.service_name)
            metrics_lib.inc_counter('skytpu_lb_requests_total',
                                    service=self.service_name,
                                    replica='none', code='429')
            tracing.record_instant(rid, 'lb.shed',
                                   retry_after_s=retry_after,
                                   excess_tokens=round(excess, 1))
            return web.json_response(
                {'error': f'service {self.service_name} over queue '
                          f'limit; retry after {retry_after}s'},
                status=429,
                headers={'Retry-After': str(retry_after),
                         tracing.TRACE_HEADER: rid})
        url = self.policy.select(route_urls)
        if url is None:
            metrics_lib.inc_counter('skytpu_lb_no_ready_replicas_total',
                                    service=self.service_name)
            # Rejections land in the requests_total family too (under
            # replica="none"), so sum(skytpu_lb_requests_total) equals
            # the demand signal the autoscaler reads — rejected demand
            # still argues for scale-up.
            metrics_lib.inc_counter('skytpu_lb_requests_total',
                                    service=self.service_name,
                                    replica='none', code='503')
            retry_after = self._no_ready_retry_after()
            tracing.record_instant(rid, 'lb.no_ready_replicas',
                                   retry_after_s=retry_after)
            return web.json_response(
                {'error': f'no ready replicas for {self.service_name}'},
                status=503,
                headers={'Retry-After': str(retry_after),
                         tracing.TRACE_HEADER: rid})
        decode_targets = self._pick_decode_targets(decode_urls) \
            if disagg else []
        target = url.rstrip('/') + '/' + str(request.rel_url).lstrip('/')
        replica = labels.get(url, url)
        # Routing decision + the per-replica signals it was made on
        # (what the policy KNEW: backlog, outstanding, latency EWMA).
        obs = self._backlog.get(url)
        signals = {'backlog_tokens': obs[0] if obs is not None else None}
        signals.update(self.policy.snapshot(url))
        if disagg:
            signals['role'] = self._roles.get(url, 'prefill')
            signals['decode_candidates'] = len(decode_targets)
        tracing.record_instant(
            rid, 'lb.route', replica=str(replica),
            ready_replicas=len(urls), **signals)
        self.policy.on_request_start(url)
        t0 = time.perf_counter()
        code = '502'
        resp: Optional[web.StreamResponse] = None
        try:
            headers = {k: v for k, v in request.headers.items()
                       if k.lower() not in _HOP_HEADERS}
            # Propagate the trace id: the replica's engine spans key on
            # it, making the LB->replica trace one request's story.
            headers[tracing.TRACE_HEADER] = rid
            if decode_targets:
                # Disaggregation: name the decode candidates for the
                # prefill replica's KV-page push (kv_transfer.py is
                # jax-free, so importing its header constant here does
                # not drag a device runtime into the LB).
                from skypilot_tpu_torch.inference.kv_transfer import (
                    DECODE_URL_HEADER)
                headers[DECODE_URL_HEADER] = ','.join(decode_targets)
            body = await request.read()
            assert self._session is not None
            async with self._session.request(
                    request.method, target, headers=headers,
                    data=body if body else None,
                    allow_redirects=False,
                    timeout=aiohttp.ClientTimeout(
                        total=None,
                        sock_connect=_UPSTREAM_CONNECT_TIMEOUT_SECONDS,
                        sock_read=_UPSTREAM_IDLE_TIMEOUT_SECONDS,
                    )) as upstream:
                code = str(upstream.status)
                backlog_raw = upstream.headers.get(BACKLOG_HEADER)
                if backlog_raw is not None:
                    try:
                        self._note_backlog(url, float(backlog_raw))
                    except ValueError:
                        pass
                resp = web.StreamResponse(status=upstream.status)
                for k, v in upstream.headers.items():
                    if k.lower() not in _HOP_HEADERS and \
                            k.lower() != 'content-length':
                        resp.headers[k] = v
                await resp.prepare(request)
                async for chunk in upstream.content.iter_chunked(
                        64 * 1024):
                    await resp.write(chunk)
                await resp.write_eof()
                return resp
        except (aiohttp.ClientError, asyncio.TimeoutError) as e:
            # Upstream (replica) failure — including a replica that died
            # MID-STREAM after latching its 200: re-latch to 502 so the
            # per-replica counter exposes the failure, not a success.
            code = '502'
            logger.warning(f'LB {self.service_name}: replica {url} '
                           f'errored: {e}')
            # The id header rides EVERY outcome — a failed exchange is
            # exactly the one the caller wants to `skytpu trace`.
            return web.json_response(
                {'error': f'replica request failed: {e}'}, status=502,
                headers={tracing.TRACE_HEADER: rid})
        except OSError as e:
            # Raw OSError here is a CLIENT-side socket failure: upstream
            # I/O errors arrive wrapped as aiohttp.ClientError (caught
            # above).  Either way the replica is healthy — don't let
            # client churn show up as per-replica 5xx.
            if resp is not None and resp.prepared:
                # Disconnect mid-stream (common for streaming
                # completions): keep the replica's real status.
                logger.debug(f'LB {self.service_name}: client '
                             f'disconnected mid-stream: {e}')
                return resp
            # Abort before the response started (e.g. mid-upload):
            # 499 = client closed request.
            code = '499'
            logger.debug(f'LB {self.service_name}: client aborted '
                         f'before response: {e}')
            return web.Response(status=499,
                                headers={tracing.TRACE_HEADER: rid})
        finally:
            t_end = time.perf_counter()
            duration_s = t_end - t0
            self.policy.on_request_end(url, duration_s)
            tracing.record_span(rid, 'lb.proxy', t0, t_end,
                                replica=str(replica), code=code)
            metrics_lib.observe_hist(
                'skytpu_lb_request_duration_seconds',
                duration_s,
                service=self.service_name, replica=replica)
            metrics_lib.inc_counter(
                'skytpu_lb_requests_total',
                service=self.service_name, replica=replica, code=code)

    def _replica_pairs(self) -> List[Tuple]:
        """[(replica_label, url)] for federation, via _ready() so the
        ready-set-change pruning (backlog, scrape-age gauges, policy
        state) runs on federation paths too — a service scraped but
        never proxied to must still drop departed replicas' series.
        With no id view the label falls back to the URL (stable across
        scrapes; a positional index would splice one replica's history
        into another's whenever the ready set changes)."""
        urls, labels = self._ready()
        return [(labels.get(u, u), u) for u in urls]

    async def _metrics(self, _request: web.Request) -> web.Response:
        """Federated scrape: own registry + each ready replica's
        /metrics relabeled with replica="<id>".  A replica that is
        down, slow, or serving a non-exposition payload is skipped —
        one bad replica must not fail the whole service's scrape."""
        replicas = self._replica_pairs()

        async def scrape(rid, url):
            try:
                assert self._session is not None
                async with self._session.get(
                        url.rstrip('/') + '/metrics',
                        timeout=aiohttp.ClientTimeout(
                            total=_FEDERATE_TIMEOUT_SECONDS)) as resp:
                    if resp.status == 200:
                        text = await resp.text()
                        # Guard against the write-after-prune replant:
                        # a scrape that was in flight when its replica
                        # left the ready set must not resurrect the
                        # departed URL's age baseline.
                        if url in self._last_ready_set:
                            self._scrape_ok_at[url] = time.monotonic()
                        self._note_backlog_from_exposition(url, text)
                        return (str(rid), text)
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError) as e:
                logger.debug(f'LB {self.service_name}: replica {rid} '
                             f'metrics scrape failed: {e}')
            return None

        # Concurrent scrapes: one slow replica costs the whole-service
        # scrape _FEDERATE_TIMEOUT_SECONDS, not timeout x replicas.
        texts = [t for t in await asyncio.gather(
            *(scrape(rid, url) for rid, url in replicas)) if t]
        # Per-replica scrape age: how stale the federated view of each
        # replica is RIGHT NOW (0 on a replica this scrape reached;
        # growing while a replica scrapes dark).  PR 9's window expiry
        # silently drops dark replicas from SLO decisions — this gauge
        # makes that staleness visible to dashboards/alerts.
        now = time.monotonic()
        for rid, url in replicas:
            ok_at = self._scrape_ok_at.get(url)
            if ok_at is None:
                # Never scraped successfully: dark since it JOINED (not
                # since the LB started — a fresh replica is seconds
                # dark, not the LB's uptime).
                ok_at = self._ready_since.get(url, self._started_mono)
            age = now - ok_at
            metrics_lib.set_gauge('skytpu_lb_scrape_age_seconds',
                                  round(age, 3),
                                  service=self.service_name,
                                  replica=str(rid))
            self._scrape_age_labels[url] = str(rid)
        return web.Response(
            text=metrics_lib.merge_federated(metrics_lib.render(), texts),
            content_type='text/plain')

    # ----- flight-recorder federation -----------------------------------------
    async def _fetch_debug_json(self, url: str, path: str,
                                timeout: float = _FEDERATE_TIMEOUT_SECONDS):
        """GET one replica's /debug endpoint; None on any failure (a
        dead replica must not fail the federated view)."""
        try:
            assert self._session is not None
            async with self._session.get(
                    url.rstrip('/') + path,
                    timeout=aiohttp.ClientTimeout(total=timeout)) as resp:
                if resp.status == 200:
                    return await resp.json()
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError,
                ValueError) as e:
            logger.debug(f'LB {self.service_name}: debug fetch {path} '
                         f'from {url} failed: {e}')
        return None

    async def _debug_requests(self, _request: web.Request
                              ) -> web.Response:
        """Federated flight-recorder index: the LB's own recent request
        summaries merged with every ready replica's (same pattern as
        the /metrics federation).  `events` is a LOWER BOUND (max
        across sources): counts cannot be summed without knowing the
        source overlap — library-direct deployments share one recorder
        — and the per-id view (which dedupes actual events) is the
        accurate one."""
        replicas = self._replica_pairs()
        docs = await asyncio.gather(
            *(self._fetch_debug_json(url, '/debug/requests')
              for _, url in replicas))
        merged = {s['request_id']: dict(s)
                  for s in tracing.recent_requests()}
        for (rid_label, _), doc in zip(replicas, docs):
            for s in (doc or {}).get('requests', []):
                cur = merged.get(s['request_id'])
                if cur is None:
                    merged[s['request_id']] = dict(s)
                    cur = merged[s['request_id']]
                else:
                    cur['first_ts'] = min(cur['first_ts'], s['first_ts'])
                    cur['last_ts'] = max(cur['last_ts'], s['last_ts'])
                    cur['events'] = max(cur['events'], s['events'])
                    cur['spans'] = cur['spans'] + [
                        n for n in s['spans'] if n not in cur['spans']]
                cur.setdefault('replica', str(rid_label))
        out = sorted(merged.values(), key=lambda s: s['last_ts'],
                     reverse=True)
        return web.json_response({'service': self.service_name,
                                  'requests': out})

    async def _debug_profile(self, request: web.Request) -> web.Response:
        """Federated on-demand profiler capture: trigger /debug/profile
        on every ready replica concurrently and return the per-replica
        capture summaries.  The fetch timeout is extended past the
        requested capture window (the replica holds the request open
        for the whole duration); a replica mid-capture (409) or dark
        reports as failed without failing the rest."""
        duration_ms = request.query.get('duration_ms', '500')
        try:
            timeout = (float(duration_ms) / 1e3 +
                       _FEDERATE_TIMEOUT_SECONDS)
        except ValueError:
            return web.json_response(
                {'error': 'duration_ms must be a number'}, status=400)
        replicas = self._replica_pairs()
        quoted = urllib.parse.quote(duration_ms, safe='')
        docs = await asyncio.gather(
            *(self._fetch_debug_json(
                url, f'/debug/profile?duration_ms={quoted}',
                timeout=timeout)
              for _, url in replicas))
        out = []
        for (rid_label, url), doc in zip(replicas, docs):
            if doc is None:
                out.append({'replica': str(rid_label), 'ok': False})
            else:
                out.append({'replica': str(rid_label), 'ok': True,
                            'url': url, **doc})
        return web.json_response({'service': self.service_name,
                                  'captures': out})

    async def _debug_request(self, request: web.Request) -> web.Response:
        """Federated per-request trace: the LB's own span events
        (admission, routing decision, proxy) merged with the owning
        replica's engine spans — one query answers "where did this
        request's time go" across the whole data plane.  Deduped, so a
        library-direct deployment (LB and replica in one process, one
        recorder) reports each event once."""
        rid = request.match_info['request_id']
        replicas = self._replica_pairs()
        quoted = urllib.parse.quote(rid, safe='')
        docs = await asyncio.gather(
            *(self._fetch_debug_json(url, f'/debug/requests/{quoted}')
              for _, url in replicas))
        events = tracing.events_for(rid)
        for doc in docs:
            events.extend((doc or {}).get('events', []))
        payload = tracing.debug_request_payload(
            rid, events=events, fmt=request.query.get('format', ''))
        if payload is None:
            return web.json_response(
                {'error': f'request id {rid!r} not in any flight '
                          f'recorder (evicted or never seen)'},
                status=404)
        return web.json_response(payload)

    async def _alerts(self, _request: web.Request) -> web.Response:
        """Federated SLO alert view: the durable obs_alerts rows the
        controller's alert engine maintains, served at the same
        endpoint the service is reached on — `skytpu alerts` needs
        only the LB URL, exactly like /metrics and /debug/requests."""
        from skypilot_tpu_torch.obs import store as obs_store
        from skypilot_tpu_torch.serve import serve_state
        try:
            store = obs_store.TelemetryStore(
                serve_state._db_path())  # pylint: disable=protected-access
            doc = {
                'service': self.service_name,
                'active': store.active_alerts(self.service_name),
                'history': store.alert_history(self.service_name,
                                               limit=50),
            }
        except Exception as e:  # pylint: disable=broad-except
            return web.json_response({'error': repr(e)}, status=500)
        return web.json_response(doc)

    # ----- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        assert self._thread is None, 'LB already started'
        self._thread = threading.Thread(
            target=self._serve_forever,
            name=f'serve-lb-{self.service_name}', daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10.0):
            raise RuntimeError(
                f'load balancer for {self.service_name!r} failed to start')

    def _serve_forever(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)

        async def _start():
            self._session = aiohttp.ClientSession()
            app = web.Application()
            # /metrics and /debug are served locally (and federate the
            # replicas); registered before the catch-all proxy route.
            app.router.add_get('/metrics', self._metrics)
            app.router.add_get('/debug/requests', self._debug_requests)
            app.router.add_get('/debug/requests/{request_id}',
                               self._debug_request)
            app.router.add_get('/debug/profile', self._debug_profile)
            app.router.add_get('/alerts', self._alerts)
            app.router.add_route('*', '/{tail:.*}', self._handle)
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, '0.0.0.0', self.port)
            await site.start()
            return runner

        self._runner = loop.run_until_complete(_start())
        self._started.set()
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(self._session.close())
            loop.run_until_complete(self._runner.cleanup())
            loop.close()

    def stop(self) -> None:
        loop, thread = self._loop, self._thread
        if loop is None or thread is None:
            return
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10.0)
        self._loop = None
        self._thread = None

    @property
    def endpoint(self) -> str:
        return f'http://127.0.0.1:{self.port}'
