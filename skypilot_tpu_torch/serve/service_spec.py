"""Service spec: the `service:` section of a task YAML
(capability parity: sky/serve/service_spec.py).

Parsed once at `serve up` and persisted with the service record so the
controller can be re-adopted after an API-server restart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.utils import schemas


@dataclasses.dataclass(frozen=True)
class ReadinessProbe:
    path: str = '/'
    initial_delay_seconds: float = 60.0
    timeout_seconds: float = 5.0
    # When set, the probe is a POST with this JSON body (the reference's
    # post_data probe for completion endpoints).
    post_data: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class DisaggregationSpec:
    """Disaggregated prefill/decode pools (requires kv_page_size —
    pages are the KV-transfer unit).  Base sizes are the pools'
    floors; the *_max knobs open independent autoscaling per pool
    (TTFT violations size prefill, TPOT violations size decode).  Spot
    placement is per pool; a spot pool holds `spot_headroom` replicas
    above its SLO-driven target so one preemption degrades headroom
    instead of breaching the SLO while the re-plan provisions."""
    prefill_replicas: int = 1
    decode_replicas: int = 1
    prefill_max_replicas: Optional[int] = None
    decode_max_replicas: Optional[int] = None
    use_spot_prefill: bool = False
    use_spot_decode: bool = False
    spot_headroom: int = 1

    def min_for(self, role: str) -> int:
        return (self.prefill_replicas if role == 'prefill'
                else self.decode_replicas)

    def max_for(self, role: str) -> int:
        cap = (self.prefill_max_replicas if role == 'prefill'
               else self.decode_max_replicas)
        return cap if cap is not None else self.min_for(role)

    def use_spot(self, role: str) -> bool:
        return (self.use_spot_prefill if role == 'prefill'
                else self.use_spot_decode)


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    """Validated, immutable service configuration."""
    readiness_probe: ReadinessProbe
    min_replicas: int = 1
    max_replicas: Optional[int] = None       # None: fixed at min_replicas
    target_qps_per_replica: Optional[float] = None
    upscale_delay_seconds: float = 300.0
    downscale_delay_seconds: float = 1200.0
    load_balancing_policy: str = 'least_load'
    # Spot-replica policy (reference: autoscalers.py dynamic fallback).
    dynamic_ondemand_fallback: bool = False
    base_ondemand_fallback_replicas: int = 0
    # Tensor-parallel degree for the replica's decode engine: the
    # inference server shards weights/KV cache over this many chips
    # (reaches the workload as SKYTPU_SERVE_TENSOR; 1 = single-chip).
    tensor_parallel: int = 1
    # Longest admissible prompt per request (tokens).  None: the model
    # limit (max_seq_len - 1) — chunked prefill makes anything up to
    # that servable.  Reaches the workload as
    # SKYTPU_SERVE_MAX_PROMPT_LEN (the inference server's
    # --max-prompt-len default).
    max_prompt_len: Optional[int] = None
    # Paged KV cache page size (tokens) for the replica's engine: break
    # the slot-contiguous KV cache into pages so admission charges
    # pages instead of reserving max_seq_len per slot, and prefix_cache
    # below can share pages across requests.  Must divide the engine's
    # prefill buckets and max_seq_len.  None = contiguous layout.
    # Reaches the workload as SKYTPU_SERVE_KV_PAGE_SIZE.
    kv_page_size: Optional[int] = None
    # Page-pool size in pages (needs kv_page_size).  None = full
    # backing (n_slots * max_seq_len / kv_page_size + 1) — paging with
    # zero admission risk but no HBM saving; sizing it to the traffic
    # actually served is where KV HBM per slot drops.  Reaches the
    # workload as SKYTPU_SERVE_KV_PAGES.
    kv_pages: Optional[int] = None
    # Radix prefix cache over the paged KV pool (needs kv_page_size):
    # shared prompt prefixes are prefilled once per replica and
    # referenced by every matching request.  None = engine default
    # (on when paging is on).  Reaches the workload as
    # SKYTPU_SERVE_PREFIX_CACHE.
    prefix_cache: Optional[bool] = None
    # KV-page storage dtype (needs kv_page_size): 'int8' quantizes
    # pages at scatter time (per-page absmax scale stored alongside),
    # halving decode's KV HBM traffic — the lever on bytes-per-token
    # when decode is bandwidth-bound.  None = engine default ('bf16').
    # Reaches the workload as SKYTPU_SERVE_KV_DTYPE.
    kv_dtype: Optional[str] = None
    # Self-speculative n-gram decoding (needs kv_page_size): draft
    # length k per verify step — the engine drafts k tokens from the
    # request's own history and verifies all of them in ONE fixed-shape
    # dispatch, so accepted drafts amortize the per-step weight read.
    # None / 0 = off.  Reaches the workload as SKYTPU_SERVE_SPEC_NGRAM.
    speculation: Optional[int] = None
    # Latency SLO targets (milliseconds): with either set, the
    # controller runs the SLOAutoscaler — scale up on p95 TTFT/TPOT
    # violation measured from the LB's federated histograms, scale down
    # only when the projected post-scale-down p95 still meets the SLO.
    # QPS (target_qps_per_replica) stays the fallback signal when no
    # histogram samples exist in the window.
    target_ttft_ms: Optional[float] = None
    target_tpot_ms: Optional[float] = None
    # Queue-aware load shedding at the LB: 429 + Retry-After once every
    # ready replica's engine backlog (queued prefill tokens) reaches
    # this, BEFORE the replicas saturate.  None disables shedding
    # (legacy behavior: reject only at zero ready replicas).
    max_queue_tokens_per_replica: Optional[int] = None
    # Disaggregated prefill/decode pools (None = monolithic replicas,
    # byte-identical legacy behavior).  Replicas launch with a role
    # (SKYTPU_SERVE_ROLE), the LB routes through the prefill pool and
    # hands prefilled KV pages to the decode pool, and the autoscaler
    # sizes the two pools independently.
    disaggregation: Optional[DisaggregationSpec] = None

    @classmethod
    def from_yaml_config(cls, config: Dict[str, Any]) -> 'ServiceSpec':
        schemas.validate_service_config(config)
        probe_raw = config['readiness_probe']
        if isinstance(probe_raw, str):
            probe = ReadinessProbe(path=probe_raw)
        else:
            probe = ReadinessProbe(
                path=probe_raw['path'],
                initial_delay_seconds=float(
                    probe_raw.get('initial_delay_seconds', 60.0)),
                timeout_seconds=float(
                    probe_raw.get('timeout_seconds', 5.0)),
                post_data=probe_raw.get('post_data'))
        policy = config.get('replica_policy')
        fixed = config.get('replicas')
        if policy is not None and fixed is not None:
            raise exceptions.InvalidTaskError(
                'service: give either `replicas` (fixed) or '
                '`replica_policy` (autoscaling), not both')
        tensor_parallel = int(config.get('tensor_parallel', 1))
        max_prompt_raw = config.get('max_prompt_len')
        max_prompt_len = (int(max_prompt_raw)
                          if max_prompt_raw is not None else None)
        page_raw = config.get('kv_page_size')
        kv_page_size = int(page_raw) if page_raw is not None else None
        pages_raw = config.get('kv_pages')
        kv_pages = int(pages_raw) if pages_raw is not None else None
        prefix_raw = config.get('prefix_cache')
        prefix_cache = (bool(prefix_raw)
                        if prefix_raw is not None else None)
        if prefix_cache and kv_page_size is None:
            raise exceptions.InvalidTaskError(
                'service.prefix_cache requires service.kv_page_size '
                '(the cache shares KV at page granularity)')
        if kv_pages is not None and kv_page_size is None:
            raise exceptions.InvalidTaskError(
                'service.kv_pages requires service.kv_page_size '
                '(it sizes the paged pool)')
        kv_dtype = config.get('kv_dtype')
        if kv_dtype is not None and kv_page_size is None:
            raise exceptions.InvalidTaskError(
                'service.kv_dtype requires service.kv_page_size '
                '(quantization happens at page-scatter time)')
        spec_raw = config.get('speculation')
        speculation = int(spec_raw) if spec_raw is not None else None
        if speculation and kv_page_size is None:
            raise exceptions.InvalidTaskError(
                'service.speculation requires service.kv_page_size '
                '(the verify dispatch scatters drafts through the '
                'page table)')
        shed_raw = config.get('max_queue_tokens_per_replica')
        max_queue_tokens = int(shed_raw) if shed_raw is not None else None
        if max_queue_tokens is not None and max_queue_tokens <= 0:
            raise exceptions.InvalidTaskError(
                'service.max_queue_tokens_per_replica must be positive '
                f'(got {max_queue_tokens}) — a zero limit sheds every '
                'request')
        disagg_raw = config.get('disaggregation')
        disaggregation = None
        if disagg_raw is not None:
            if kv_page_size is None:
                raise exceptions.InvalidTaskError(
                    'service.disaggregation requires service.'
                    'kv_page_size — KV pages are the prefill->decode '
                    'transfer unit')
            disaggregation = DisaggregationSpec(
                prefill_replicas=int(disagg_raw['prefill_replicas']),
                decode_replicas=int(disagg_raw['decode_replicas']),
                prefill_max_replicas=(
                    int(disagg_raw['prefill_max_replicas'])
                    if disagg_raw.get('prefill_max_replicas') is not None
                    else None),
                decode_max_replicas=(
                    int(disagg_raw['decode_max_replicas'])
                    if disagg_raw.get('decode_max_replicas') is not None
                    else None),
                use_spot_prefill=bool(
                    disagg_raw.get('use_spot_prefill', False)),
                use_spot_decode=bool(
                    disagg_raw.get('use_spot_decode', False)),
                spot_headroom=int(disagg_raw.get('spot_headroom', 1)),
            )
            for role in ('prefill', 'decode'):
                if disaggregation.max_for(role) < \
                        disaggregation.min_for(role):
                    raise exceptions.InvalidTaskError(
                        f'service.disaggregation: {role}_max_replicas '
                        f'({disaggregation.max_for(role)}) < '
                        f'{role}_replicas '
                        f'({disaggregation.min_for(role)})')
        if policy is None:
            n = int(fixed if fixed is not None else 1)
            return cls(readiness_probe=probe, min_replicas=n,
                       max_replicas=None, target_qps_per_replica=None,
                       load_balancing_policy=config.get(
                           'load_balancing_policy', 'least_load'),
                       tensor_parallel=tensor_parallel,
                       max_prompt_len=max_prompt_len,
                       kv_page_size=kv_page_size,
                       kv_pages=kv_pages,
                       prefix_cache=prefix_cache,
                       kv_dtype=kv_dtype,
                       speculation=speculation,
                       max_queue_tokens_per_replica=max_queue_tokens,
                       disaggregation=disaggregation)
        min_r = int(policy.get('min_replicas', 1))
        max_r = policy.get('max_replicas')
        target_qps = policy.get('target_qps_per_replica')
        if target_qps is not None and max_r is None:
            raise exceptions.InvalidTaskError(
                'service.replica_policy: target_qps_per_replica requires '
                'max_replicas')
        if max_r is not None and target_qps is None:
            raise exceptions.InvalidTaskError(
                'service.replica_policy: max_replicas without '
                'target_qps_per_replica — autoscaling needs a QPS target '
                '(or drop max_replicas for a fixed-size service)')
        if max_r is not None and int(max_r) < min_r:
            raise exceptions.InvalidTaskError(
                f'service.replica_policy: max_replicas ({max_r}) < '
                f'min_replicas ({min_r})')
        target_ttft = policy.get('target_ttft_ms')
        target_tpot = policy.get('target_tpot_ms')
        for knob, val in (('target_ttft_ms', target_ttft),
                          ('target_tpot_ms', target_tpot)):
            if val is not None and float(val) <= 0:
                raise exceptions.InvalidTaskError(
                    f'service.replica_policy: {knob} must be a positive '
                    f'latency in milliseconds (got {val})')
        if (target_ttft is not None or target_tpot is not None) and \
                target_qps is None:
            # The SLO autoscaler falls back to QPS when the histogram
            # window is empty (cold service, replicas not yet scraped):
            # without a QPS target there is no fallback signal at all.
            raise exceptions.InvalidTaskError(
                'service.replica_policy: target_ttft_ms/target_tpot_ms '
                'require target_qps_per_replica (and max_replicas) — '
                'QPS is the fallback signal when no latency samples '
                'exist yet')
        return cls(
            readiness_probe=probe,
            min_replicas=min_r,
            max_replicas=int(max_r) if max_r is not None else None,
            target_qps_per_replica=(float(target_qps)
                                    if target_qps is not None else None),
            upscale_delay_seconds=float(
                policy.get('upscale_delay_seconds', 300.0)),
            downscale_delay_seconds=float(
                policy.get('downscale_delay_seconds', 1200.0)),
            load_balancing_policy=config.get('load_balancing_policy',
                                             'least_load'),
            dynamic_ondemand_fallback=bool(
                policy.get('dynamic_ondemand_fallback', False)),
            base_ondemand_fallback_replicas=int(
                policy.get('base_ondemand_fallback_replicas', 0)),
            tensor_parallel=tensor_parallel,
            max_prompt_len=max_prompt_len,
            kv_page_size=kv_page_size,
            kv_pages=kv_pages,
            prefix_cache=prefix_cache,
            kv_dtype=kv_dtype,
            speculation=speculation,
            target_ttft_ms=(float(target_ttft)
                            if target_ttft is not None else None),
            target_tpot_ms=(float(target_tpot)
                            if target_tpot is not None else None),
            max_queue_tokens_per_replica=max_queue_tokens,
            disaggregation=disaggregation,
        )

    def to_yaml_config(self) -> Dict[str, Any]:
        probe: Dict[str, Any] = {'path': self.readiness_probe.path}
        if self.readiness_probe.initial_delay_seconds != 60.0:
            probe['initial_delay_seconds'] = \
                self.readiness_probe.initial_delay_seconds
        if self.readiness_probe.timeout_seconds != 5.0:
            probe['timeout_seconds'] = self.readiness_probe.timeout_seconds
        if self.readiness_probe.post_data is not None:
            probe['post_data'] = self.readiness_probe.post_data
        out: Dict[str, Any] = {'readiness_probe': probe}
        if self.autoscaling_enabled:
            policy: Dict[str, Any] = {
                'min_replicas': self.min_replicas,
                'max_replicas': self.max_replicas,
            }
            if self.target_qps_per_replica is not None:
                policy['target_qps_per_replica'] = \
                    self.target_qps_per_replica
            policy['upscale_delay_seconds'] = self.upscale_delay_seconds
            policy['downscale_delay_seconds'] = \
                self.downscale_delay_seconds
            if self.dynamic_ondemand_fallback:
                policy['dynamic_ondemand_fallback'] = True
            if self.base_ondemand_fallback_replicas:
                policy['base_ondemand_fallback_replicas'] = \
                    self.base_ondemand_fallback_replicas
            if self.target_ttft_ms is not None:
                policy['target_ttft_ms'] = self.target_ttft_ms
            if self.target_tpot_ms is not None:
                policy['target_tpot_ms'] = self.target_tpot_ms
            out['replica_policy'] = policy
        else:
            out['replicas'] = self.min_replicas
        out['load_balancing_policy'] = self.load_balancing_policy
        if self.tensor_parallel != 1:
            out['tensor_parallel'] = self.tensor_parallel
        if self.max_prompt_len is not None:
            out['max_prompt_len'] = self.max_prompt_len
        if self.kv_page_size is not None:
            out['kv_page_size'] = self.kv_page_size
        if self.kv_pages is not None:
            out['kv_pages'] = self.kv_pages
        if self.prefix_cache is not None:
            out['prefix_cache'] = self.prefix_cache
        if self.kv_dtype is not None:
            out['kv_dtype'] = self.kv_dtype
        if self.speculation is not None:
            out['speculation'] = self.speculation
        if self.max_queue_tokens_per_replica is not None:
            out['max_queue_tokens_per_replica'] = \
                self.max_queue_tokens_per_replica
        if self.disaggregation is not None:
            d = self.disaggregation
            block: Dict[str, Any] = {
                'prefill_replicas': d.prefill_replicas,
                'decode_replicas': d.decode_replicas,
            }
            if d.prefill_max_replicas is not None:
                block['prefill_max_replicas'] = d.prefill_max_replicas
            if d.decode_max_replicas is not None:
                block['decode_max_replicas'] = d.decode_max_replicas
            if d.use_spot_prefill:
                block['use_spot_prefill'] = True
            if d.use_spot_decode:
                block['use_spot_decode'] = True
            if d.spot_headroom != 1:
                block['spot_headroom'] = d.spot_headroom
            out['disaggregation'] = block
        return out

    @property
    def autoscaling_enabled(self) -> bool:
        return self.max_replicas is not None and \
            self.target_qps_per_replica is not None

    @property
    def slo_autoscaling_enabled(self) -> bool:
        """Latency-SLO autoscaling: scale on p95 TTFT/TPOT from the
        federated histograms, with QPS as the fallback signal."""
        return self.autoscaling_enabled and (
            self.target_ttft_ms is not None or
            self.target_tpot_ms is not None)
