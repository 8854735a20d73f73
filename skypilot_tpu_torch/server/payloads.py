"""Request-body schemas for every mutating route (parity:
sky/server/requests/payloads.py — pydantic there, jsonschema here to
match the framework's existing validation layer, utils/schemas.py).

A malformed POST is a 400 with the offending path, never a 500 KeyError.
"""
from __future__ import annotations

from typing import Any, Dict

import jsonschema

from skypilot_tpu_torch import exceptions

_TASK = {'type': 'object'}          # deep-validated by Task.from_yaml_config
_NAME = {'type': 'string', 'minLength': 1}

SCHEMAS: Dict[str, Dict[str, Any]] = {
    'launch': {
        'type': 'object',
        'required': ['task'],
        'properties': {
            'task': _TASK,
            'cluster_name': {'type': ['string', 'null']},
            'dryrun': {'type': 'boolean'},
            'retry_until_up': {'type': 'boolean'},
        },
        'additionalProperties': False,
    },
    'exec': {
        'type': 'object',
        'required': ['task', 'cluster_name'],
        'properties': {'task': _TASK, 'cluster_name': _NAME},
        'additionalProperties': False,
    },
    'cluster_op': {   # down / stop / start
        'type': 'object',
        'required': ['cluster_name'],
        'properties': {'cluster_name': _NAME},
        'additionalProperties': False,
    },
    'autostop': {
        'type': 'object',
        'required': ['cluster_name'],
        'properties': {
            'cluster_name': _NAME,
            'idle_minutes': {'type': 'integer', 'minimum': -1},
            'down': {'type': 'boolean'},
        },
        'additionalProperties': False,
    },
    'cancel': {
        'type': 'object',
        'required': ['cluster_name', 'job_id'],
        'properties': {'cluster_name': _NAME,
                       'job_id': {'type': 'integer', 'minimum': 0}},
        'additionalProperties': False,
    },
    'jobs_launch': {
        'type': 'object',
        # Either a single task or a pipeline (list of tasks run as a
        # chain, sky/jobs/controller.py:98).
        'anyOf': [{'required': ['task']}, {'required': ['tasks']}],
        'properties': {
            'task': _TASK,
            'tasks': {'type': 'array', 'items': _TASK, 'minItems': 1},
            'name': {'type': ['string', 'null']},
        },
        'additionalProperties': False,
    },
    'jobs_cancel': {
        'type': 'object',
        'required': ['job_id'],
        'properties': {'job_id': {'type': 'integer', 'minimum': 0}},
        'additionalProperties': False,
    },
    'serve_up': {
        'type': 'object',
        'required': ['task'],
        'properties': {'task': _TASK, 'name': {'type': ['string', 'null']}},
        'additionalProperties': False,
    },
    'serve_update': {
        'type': 'object',
        'required': ['task'],
        'properties': {'task': _TASK, 'name': {'type': ['string', 'null']}},
        'additionalProperties': False,
    },
    'volumes_apply': {
        'type': 'object',
        'required': ['name', 'vtype', 'infra', 'size_gb'],
        'properties': {
            'name': _NAME,
            'vtype': {'enum': ['k8s-pvc', 'gcp-disk']},
            'infra': _NAME,
            'size_gb': {'type': 'integer', 'minimum': 1},
            'config': {'type': 'object'},
        },
        'additionalProperties': False,
    },
    'volumes_delete': {
        'type': 'object',
        'required': ['name'],
        'properties': {'name': _NAME},
        'additionalProperties': False,
    },
    'serve_down': {
        'type': 'object',
        'required': ['name'],
        'properties': {'name': _NAME, 'purge': {'type': 'boolean'}},
        'additionalProperties': False,
    },
}


def validate(schema_name: str, body: Any) -> None:
    """Raise InvalidRequestError (HTTP 400 upstream) on mismatch."""
    if not isinstance(body, dict):
        raise exceptions.InvalidRequestError('request body must be a '
                                             'JSON object')
    try:
        jsonschema.validate(body, SCHEMAS[schema_name])
    except jsonschema.ValidationError as e:
        path = '.'.join(str(p) for p in e.absolute_path) or '<root>'
        raise exceptions.InvalidRequestError(
            f'invalid request at {path!r}: {e.message}') from e
