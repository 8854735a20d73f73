"""Logger setup (parity: sky/sky_logging.py)."""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = '%(levelname).1s %(asctime)s %(name)s:%(lineno)d] %(message)s'
_DATE_FORMAT = '%m-%d %H:%M:%S'
_initialized = False


def _init_root() -> None:
    global _initialized
    if _initialized:
        return
    root = logging.getLogger('skypilot_tpu')
    level_name = os.environ.get('SKYTPU_LOG_LEVEL', 'INFO').upper()
    root.setLevel(getattr(logging, level_name, logging.INFO))
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, _DATE_FORMAT))
        root.addHandler(handler)
    root.propagate = False
    _initialized = True


def init_logger(name: str) -> logging.Logger:
    _init_root()
    return logging.getLogger(name)
