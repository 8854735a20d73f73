"""Layered configuration (capability parity: sky/skypilot_config.py).

Precedence (low → high), same semantics as the reference
(sky/skypilot_config.py:91-116): server/global config < user config
(`~/.skytpu/config.yaml`) < project config (`.skytpu.yaml` in cwd) <
per-invocation overrides.  Env vars `SKYTPU_GLOBAL_CONFIG` /
`SKYTPU_PROJECT_CONFIG` redirect the file paths (analog of
ENV_VAR_GLOBAL_CONFIG / ENV_VAR_PROJECT_CONFIG).
"""
from __future__ import annotations

import contextlib
import copy
import os
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

from skypilot_tpu_torch.utils import common_utils
from skypilot_tpu_torch.utils import schemas

ENV_VAR_GLOBAL_CONFIG = 'SKYTPU_GLOBAL_CONFIG'
ENV_VAR_PROJECT_CONFIG = 'SKYTPU_PROJECT_CONFIG'
DEFAULT_GLOBAL_CONFIG_PATH = '~/.skytpu/config.yaml'
DEFAULT_PROJECT_CONFIG_PATH = '.skytpu.yaml'

_local = threading.local()
_lock = threading.Lock()
_cache: Optional[Dict[str, Any]] = None
_cache_key: Optional[Tuple[str, ...]] = None


def _config_paths() -> List[str]:
    paths = []
    global_path = os.environ.get(ENV_VAR_GLOBAL_CONFIG,
                                 DEFAULT_GLOBAL_CONFIG_PATH)
    project_path = os.environ.get(ENV_VAR_PROJECT_CONFIG,
                                  DEFAULT_PROJECT_CONFIG_PATH)
    for p in (global_path, project_path):
        p = os.path.expanduser(p)
        if os.path.exists(p):
            paths.append(p)
    return paths


def _deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _load() -> Dict[str, Any]:
    global _cache, _cache_key
    paths = _config_paths()

    def _mtime(p: str) -> float:
        try:
            return os.path.getmtime(p)
        except OSError:  # deleted between existence check and stat
            return 0.0

    key = tuple(f'{p}:{_mtime(p)}' for p in paths)
    with _lock:
        if _cache is not None and key == _cache_key:
            return _cache
        merged: Dict[str, Any] = {}
        for p in paths:
            try:
                config = common_utils.read_yaml(p)
            except OSError:  # deleted since _config_paths()
                continue
            schemas.validate_config(config)
            merged = _deep_merge(merged, config)
        _cache = merged
        _cache_key = key
        return merged


def _effective() -> Dict[str, Any]:
    config = _load()
    overrides: List[Dict[str, Any]] = getattr(_local, 'overrides', [])
    for o in overrides:
        config = _deep_merge(config, o)
    return config


def get_nested(keys: Tuple[str, ...],
               default: Any = None,
               override_configs: Optional[Dict[str, Any]] = None) -> Any:
    """Read `config[keys[0]][keys[1]]...`, honoring thread-local overrides
    (reference: skypilot_config.get_nested)."""
    config = _effective()
    if override_configs:
        config = _deep_merge(config, override_configs)
    cur: Any = config
    for k in keys:
        if not isinstance(cur, dict) or k not in cur:
            return default
        cur = cur[k]
    return cur


def to_dict() -> Dict[str, Any]:
    return copy.deepcopy(_effective())


@contextlib.contextmanager
def override(config: Dict[str, Any]) -> Iterator[None]:
    """Thread-local override, used by the API server to apply per-request
    config (the reference plumbs this via task-YAML `config:` overrides)."""
    overrides = getattr(_local, 'overrides', None)
    if overrides is None:
        overrides = _local.overrides = []
    overrides.append(config)
    try:
        yield
    finally:
        overrides.pop()


def reset_cache_for_tests() -> None:
    global _cache, _cache_key
    with _lock:
        _cache = None
        _cache_key = None
