"""Cross-cloud bucket transfer (parity: sky/data/data_transfer.py —
s3→gcs via GCS Transfer Service there; here a streaming relay through
the API-server host, which is what the reference falls back to for the
pairs its transfer services don't cover).

transfer(src, dst) for any pair of gs:// s3:// r2:// URLs or local
paths.  Same-scheme pairs use the store's native rsync; cross-scheme
pairs relay through a local staging directory (download then upload) —
explicit and bounded, with the staging dir cleaned up either way.

Hermetic tests: SKYTPU_FAKE_GCS_ROOT / SKYTPU_FAKE_S3_ROOT map bucket
URLs onto local directories, so the full relay path runs with no cloud.
"""
from __future__ import annotations

import os
import shlex
import shutil
import subprocess
import tempfile
from typing import Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import sky_logging

logger = sky_logging.init_logger(__name__)

_SCHEMES = ('gs', 's3', 'r2')


def _fake_root(scheme: str) -> Optional[str]:
    env = {'gs': 'SKYTPU_FAKE_GCS_ROOT', 's3': 'SKYTPU_FAKE_S3_ROOT',
           'r2': 'SKYTPU_FAKE_R2_ROOT'}[scheme]
    root = os.environ.get(env)
    return os.path.expanduser(root) if root else None


def _split(url: str):
    """('gs', 'bucket/prefix') for URLs; (None, path) for local paths."""
    if '://' in url:
        scheme, rest = url.split('://', 1)
        if scheme not in _SCHEMES:
            raise exceptions.StorageError(
                f'unsupported transfer URL scheme {scheme!r} '
                f'(known: {_SCHEMES})')
        return scheme, rest.strip('/')
    return None, os.path.expanduser(url)


def _run(cmd: str) -> None:
    # skytpu: allow-unbounded-io(bulk bucket-to-bucket transfer: bounded by data size, not wall time — any fixed timeout breaks large copies)
    proc = subprocess.run(cmd, shell=True, capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        raise exceptions.StorageError(
            f'transfer command failed ({proc.returncode}): {cmd}\n'
            f'{proc.stderr[-2000:]}')


def _download(scheme: str, rest: str, local_dir: str) -> None:
    root = _fake_root(scheme)
    q = shlex.quote
    if root is not None:
        src = os.path.join(root, rest)
        os.makedirs(src, exist_ok=True)
        _run(f'cp -a {q(src)}/. {q(local_dir)}/')
        return
    if scheme == 'gs':
        _run(f'gsutil -m rsync -r gs://{q(rest)} {q(local_dir)}')
    elif scheme == 's3':
        _run(f'aws s3 sync s3://{q(rest)} {q(local_dir)}')
    else:
        raise exceptions.StorageError(
            'r2 download needs an R2 endpoint configured; use the aws '
            'CLI with --endpoint-url via a custom command')


def _upload(local_dir: str, scheme: str, rest: str) -> None:
    root = _fake_root(scheme)
    q = shlex.quote
    if root is not None:
        dst = os.path.join(root, rest)
        os.makedirs(dst, exist_ok=True)
        _run(f'cp -a {q(local_dir)}/. {q(dst)}/')
        return
    if scheme == 'gs':
        _run(f'gsutil -m rsync -r {q(local_dir)} gs://{q(rest)}')
    elif scheme == 's3':
        _run(f'aws s3 sync {q(local_dir)} s3://{q(rest)}')
    else:
        raise exceptions.StorageError(
            'r2 upload needs an R2 endpoint configured')


def transfer(src: str, dst: str) -> None:
    """Copy src -> dst across stores/clouds (directories/prefixes)."""
    src_scheme, src_rest = _split(src)
    dst_scheme, dst_rest = _split(dst)
    logger.info(f'transfer {src} -> {dst}')
    # local -> remote / remote -> local: one hop.
    if src_scheme is None and dst_scheme is None:
        os.makedirs(dst_rest, exist_ok=True)
        _run(f'cp -a {shlex.quote(src_rest)}/. '
             f'{shlex.quote(dst_rest)}/')
        return
    if src_scheme is None:
        _upload(src_rest, dst_scheme, dst_rest)
        return
    if dst_scheme is None:
        os.makedirs(dst_rest, exist_ok=True)
        _download(src_scheme, src_rest, dst_rest)
        return
    # remote -> remote: relay through a staging dir (cross-cloud), or
    # native rsync when both ends fake-map / same scheme with gsutil's
    # daisy-chain ability — the relay is the general, always-correct
    # path, so use it uniformly.
    staging = tempfile.mkdtemp(prefix='skytpu-transfer-')
    try:
        _download(src_scheme, src_rest, staging)
        _upload(staging, dst_scheme, dst_rest)
    finally:
        shutil.rmtree(staging, ignore_errors=True)
