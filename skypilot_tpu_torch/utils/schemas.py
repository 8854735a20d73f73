"""JSON-schema validation of task YAML and layered config
(capability parity: sky/utils/schemas.py, 1899 LoC in the reference).

Kept deliberately small: one schema per document type, validated with
`jsonschema`.  Error messages are rewritten to point at the offending field.
"""
from __future__ import annotations

from typing import Any, Dict

import jsonschema

from skypilot_tpu_torch import exceptions

_RESOURCES_SCHEMA: Dict[str, Any] = {
    'type': 'object',
    'additionalProperties': False,
    'properties': {
        'infra': {'type': 'string'},
        'accelerators': {
            'anyOf': [{'type': 'string'},
                      {'type': 'object',
                       'additionalProperties': {'type': 'integer'}}]
        },
        'cpus': {'anyOf': [{'type': 'string'}, {'type': 'number'}]},
        'memory': {'anyOf': [{'type': 'string'}, {'type': 'number'}]},
        'instance_type': {'type': 'string'},
        'use_spot': {'type': 'boolean'},
        'spot_recovery': {'type': 'string'},
        'disk_size': {'type': 'integer', 'minimum': 1},
        'disk_tier': {'enum': ['low', 'medium', 'high', 'ultra', 'best']},
        'network_tier': {'enum': ['standard', 'best']},
        'ports': {
            'anyOf': [{'type': 'string'}, {'type': 'integer'},
                      {'type': 'array',
                       'items': {'anyOf': [{'type': 'string'},
                                           {'type': 'integer'}]}}]
        },
        'image_id': {'type': 'string'},
        'labels': {'type': 'object', 'additionalProperties': {'type': 'string'}},
        'autostop': {
            'anyOf': [{'type': 'boolean'}, {'type': 'integer'},
                      {'type': 'object'}]
        },
        'runtime_version': {'type': 'string'},
        'topology': {'type': 'string', 'pattern': r'^\d+x\d+(x\d+)?$'},
        'job_recovery': {
            'anyOf': [{'type': 'string'}, {'type': 'object'}]
        },
        'priority': {'type': 'integer', 'minimum': -1000, 'maximum': 1000},
        'accelerator_args': {'type': 'object'},
        'any_of': {'type': 'array', 'items': {'type': 'object'}},
    },
}

_SERVICE_SCHEMA: Dict[str, Any] = {
    'type': 'object',
    'additionalProperties': False,
    'required': ['readiness_probe'],
    'properties': {
        'readiness_probe': {
            'anyOf': [
                {'type': 'string'},
                {'type': 'object',
                 'additionalProperties': False,
                 'required': ['path'],
                 'properties': {
                     'path': {'type': 'string'},
                     'initial_delay_seconds': {'type': 'number'},
                     'timeout_seconds': {'type': 'number'},
                     'post_data': {'type': ['object', 'string']},
                 }},
            ]
        },
        'replica_policy': {
            'type': 'object',
            'additionalProperties': False,
            'properties': {
                'min_replicas': {'type': 'integer', 'minimum': 0},
                'max_replicas': {'type': 'integer', 'minimum': 0},
                'target_qps_per_replica': {'type': 'number'},
                'upscale_delay_seconds': {'type': 'number'},
                'downscale_delay_seconds': {'type': 'number'},
                'dynamic_ondemand_fallback': {'type': 'boolean'},
                'base_ondemand_fallback_replicas': {'type': 'integer'},
                # Latency SLO targets (milliseconds): with either set,
                # the controller scales on p95 TTFT/TPOT from the LB's
                # federated histograms (SLOAutoscaler) with QPS as the
                # fallback signal.  A zero or negative SLO is nonsense.
                'target_ttft_ms': {'type': 'number',
                                   'exclusiveMinimum': 0},
                'target_tpot_ms': {'type': 'number',
                                   'exclusiveMinimum': 0},
            },
        },
        'replicas': {'type': 'integer', 'minimum': 0},
        'load_balancing_policy': {
            'enum': ['round_robin', 'least_load', 'instance_aware']
        },
        # Tensor-parallel degree for each replica's decode engine
        # (plumbed to the workload as SKYTPU_SERVE_TENSOR).
        'tensor_parallel': {'type': 'integer', 'minimum': 1},
        # Admission cap for prompt length, in tokens (plumbed to the
        # workload as SKYTPU_SERVE_MAX_PROMPT_LEN; omitted = the model
        # limit — chunked prefill serves prompts up to max_seq_len - 1).
        'max_prompt_len': {'type': 'integer', 'minimum': 1},
        # Paged KV cache page size in tokens (plumbed to the workload
        # as SKYTPU_SERVE_KV_PAGE_SIZE; omitted = contiguous layout).
        'kv_page_size': {'type': 'integer', 'minimum': 1},
        # Page-pool size in pages (requires kv_page_size; plumbed as
        # SKYTPU_SERVE_KV_PAGES; omitted = full backing).
        'kv_pages': {'type': 'integer', 'minimum': 2},
        # Radix prefix cache over the paged pool (requires
        # kv_page_size; plumbed as SKYTPU_SERVE_PREFIX_CACHE).
        'prefix_cache': {'type': 'boolean'},
        # KV-page storage dtype (requires kv_page_size; plumbed as
        # SKYTPU_SERVE_KV_DTYPE).  'int8' halves KV HBM traffic by
        # quantizing pages at scatter time (per-page absmax scale).
        'kv_dtype': {'enum': ['bf16', 'int8']},
        # Self-speculative n-gram decoding: draft length k per verify
        # step (requires kv_page_size; plumbed as
        # SKYTPU_SERVE_SPEC_NGRAM).  0 / omitted = off.
        'speculation': {'type': 'integer', 'minimum': 0},
        # Queue-aware load shedding at the LB: when every ready
        # replica's engine backlog (queued prefill tokens, from the
        # federated gauges / replica response headers) is at or above
        # this, new requests get 429 + Retry-After instead of joining a
        # queue that already violates the SLO.  A zero limit would shed
        # everything — minimum 1.
        'max_queue_tokens_per_replica': {'type': 'integer', 'minimum': 1},
        # Disaggregated prefill/decode serving (requires kv_page_size —
        # pages are the KV-transfer unit): split the replicas into a
        # prefill pool and a decode pool; the LB routes requests into
        # the prefill pool and the prefilled KV pages are handed off
        # to a decode replica.  With SLO targets set, the two pools
        # scale INDEPENDENTLY: TTFT violations size the prefill pool,
        # TPOT violations the decode pool.
        'disaggregation': {
            'type': 'object',
            'additionalProperties': False,
            'required': ['prefill_replicas', 'decode_replicas'],
            'properties': {
                'prefill_replicas': {'type': 'integer', 'minimum': 1},
                'decode_replicas': {'type': 'integer', 'minimum': 1},
                # Autoscaling ceilings per pool; omitted = the pool is
                # fixed at its base size.
                'prefill_max_replicas': {'type': 'integer',
                                         'minimum': 1},
                'decode_max_replicas': {'type': 'integer',
                                        'minimum': 1},
                # Spot placement per pool (ThunderServe's cost lever:
                # decode replicas hold only transferred KV + their own
                # generations, so a preemption re-plans cheaply).
                'use_spot_prefill': {'type': 'boolean'},
                'use_spot_decode': {'type': 'boolean'},
                # Extra replicas a SPOT pool holds above its SLO-driven
                # target, so one preemption degrades headroom instead
                # of breaching the SLO while the re-plan provisions.
                'spot_headroom': {'type': 'integer', 'minimum': 0},
            },
        },
    },
}

TASK_SCHEMA: Dict[str, Any] = {
    'type': 'object',
    'additionalProperties': False,
    'properties': {
        'name': {'type': 'string'},
        'workdir': {'type': 'string'},
        'num_nodes': {'type': 'integer', 'minimum': 1},
        'resources': _RESOURCES_SCHEMA,
        'file_mounts': {'type': 'object'},
        'setup': {'type': 'string'},
        'run': {'type': 'string'},
        'envs': {
            'type': 'object',
            'additionalProperties': {
                'anyOf': [{'type': 'string'}, {'type': 'number'},
                          {'type': 'boolean'}, {'type': 'null'}]
            }
        },
        'secrets': {
            'type': 'object',
            'additionalProperties': {
                'anyOf': [{'type': 'string'}, {'type': 'number'},
                          {'type': 'null'}]
            }
        },
        'service': _SERVICE_SCHEMA,
        'volumes': {
            'type': 'object',
            'additionalProperties': {'type': 'string'},
        },
    },
}

CONFIG_SCHEMA: Dict[str, Any] = {
    'type': 'object',
    'additionalProperties': False,
    'properties': {
        # Control-plane state backend: a postgresql:// URL moves the
        # four state stores (clusters, requests, jobs, serve) off
        # per-host sqlite onto one shared database — the prerequisite
        # for running more than one API-server node.  Env
        # SKYTPU_DB_URL overrides.  Agent-side VM DBs stay sqlite.
        'db': {
            'type': 'object',
            'additionalProperties': False,
            'properties': {
                'url': {'type': 'string'},
            },
        },
        'api_server': {
            'type': 'object',
            'additionalProperties': False,
            'properties': {
                'endpoint': {'type': 'string'},
                'workers': {'type': 'integer'},
                'auth_token': {'type': 'string'},
                # Per-user service tokens: {token: username}.
                'tokens': {
                    'type': 'object',
                    'additionalProperties': {'type': 'string'},
                },
                # Behind an authenticating reverse proxy (oauth2-proxy
                # parity): the proxy's shared secret authorizes, its
                # identity header names the user (utils/auth.py).
                'auth_proxy': {
                    'type': 'object',
                    'additionalProperties': False,
                    'properties': {
                        'identity_header': {'type': 'string'},
                        'secret_header': {'type': 'string'},
                        'proxy_secret': {'type': 'string',
                                         'minLength': 1},
                    },
                    'required': ['proxy_secret'],
                },
            },
        },
        'gcp': {
            'type': 'object',
            'additionalProperties': False,
            'properties': {
                'project_id': {'type': 'string'},
                'use_queued_resources': {'type': 'boolean'},
                'queued_resource_timeout_s': {'type': 'number'},
                'reservation': {'type': 'string'},
                'labels': {'type': 'object'},
            },
        },
        'jobs': {
            'type': 'object',
            'additionalProperties': False,
            'properties': {
                'controller': {'type': 'object'},
                'max_parallel': {'type': 'integer'},
            },
        },
        'serve': {'type': 'object'},
        'allowed_clouds': {'type': 'array', 'items': {'type': 'string'}},
        'optimizer': {
            'type': 'object',
            'additionalProperties': False,
            'properties': {
                'minimize': {'enum': ['cost', 'time', 'cost_per_flop']},
            },
        },
        'logs': {'type': 'object'},
        'admin_policy': {'type': 'string'},
        # Opt-in usage telemetry (usage_lib.py): local JSONL sink by
        # default, optional HTTP endpoint; off unless enabled: true.
        'usage': {
            'type': 'object',
            'additionalProperties': False,
            'properties': {
                'enabled': {'type': 'boolean'},
                'path': {'type': 'string'},
                'endpoint': {'type': 'string'},
                'labels': {'type': 'object',
                           'additionalProperties': {'type': 'string'}},
            },
        },
        'users': {
            'type': 'object',
            'additionalProperties': {'enum': ['admin', 'user']},
        },
        'active_workspace': {'type': 'string'},
        'workspaces': {
            'type': 'object',
            'additionalProperties': {
                'type': 'object',
                'additionalProperties': False,
                'properties': {
                    'allowed_clouds': {'type': 'array',
                                       'items': {'type': 'string'}},
                },
            },
        },
    },
}


def _validate(config: Dict[str, Any], schema: Dict[str, Any],
              what: str) -> None:
    try:
        jsonschema.validate(config, schema)
    except jsonschema.ValidationError as e:
        path = '.'.join(str(p) for p in e.absolute_path) or '<root>'
        raise exceptions.InvalidTaskError(
            f'Invalid {what} at {path!r}: {e.message}') from e


def validate_task_config(config: Dict[str, Any]) -> None:
    _validate(config, TASK_SCHEMA, 'task YAML')


def validate_config(config: Dict[str, Any]) -> None:
    try:
        jsonschema.validate(config, CONFIG_SCHEMA)
    except jsonschema.ValidationError as e:
        path = '.'.join(str(p) for p in e.absolute_path) or '<root>'
        raise exceptions.InvalidSkyConfigError(
            f'Invalid config at {path!r}: {e.message}') from e


def validate_service_config(config: Dict[str, Any]) -> None:
    _validate(config, _SERVICE_SCHEMA, 'service spec')
