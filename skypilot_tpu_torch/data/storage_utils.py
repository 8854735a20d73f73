""".skyignore handling (parity: sky/data/storage_utils.py).

A `.skyignore` file at the root of a workdir / storage source lists
gitignore-style patterns (one per line, `#` comments, `*`/`?` globs,
trailing `/` for directories) excluded from uploads and workdir rsync.
"""
from __future__ import annotations

import fnmatch
import os
from typing import List

SKYIGNORE_FILE = '.skyignore'


def load_excludes(src_dir: str) -> List[str]:
    """Patterns from `<src_dir>/.skyignore` (always excludes the file
    itself when present)."""
    path = os.path.join(os.path.expanduser(src_dir), SKYIGNORE_FILE)
    if not os.path.isfile(path):
        return []
    patterns = [SKYIGNORE_FILE]
    with open(path, encoding='utf-8') as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            patterns.append(line.rstrip('/'))
    return patterns


def excluded(rel_path: str, patterns: List[str]) -> bool:
    """True if rel_path (posix, relative to the source root) matches any
    pattern — on its full path, its basename, or any parent directory."""
    if not patterns:
        return False
    parts = rel_path.split('/')
    for pattern in patterns:
        if fnmatch.fnmatch(rel_path, pattern) or \
                fnmatch.fnmatch(parts[-1], pattern):
            return True
        # a pattern matching a parent dir excludes everything under it
        for i in range(1, len(parts)):
            if fnmatch.fnmatch('/'.join(parts[:i]), pattern) or \
                    fnmatch.fnmatch(parts[i - 1], pattern):
                return True
    return False
