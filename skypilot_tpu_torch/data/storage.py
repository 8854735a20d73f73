"""Bucket stores: the `gs://` fetch of the checkpoint loader.

A copy of the names of `skypilot_tpu/data/storage.py` that
`inference/weights.py`'s `gs://` fetch reaches (`_fake_root`,
`_BucketStore`, `GcsStore`, `fnmatch_to_re`), verbatim and pinned by
tests/test_torch_package.py.  The cluster-mount half of the original
(mounts, copy commands, S3/R2 stores) is not here: nothing in the port
mounts a bucket on a cluster.

Hermetic boundary for tests: with SKYTPU_FAKE_GCS_ROOT set,
`gs://bucket/...` maps to `$ROOT/bucket/...` and every operation is a
local file op.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.data import storage_utils


def _fake_root() -> Optional[str]:
    root = os.environ.get('SKYTPU_FAKE_GCS_ROOT')
    return os.path.expanduser(root) if root else None


class _BucketStore:
    """Shared bucket-store skeleton: fake-root file ops (the hermetic
    test boundary) live here once; subclasses supply the scheme, the
    fake-root env, and the provider-CLI verbs (parity: the reference's
    AbstractStore, sky/data/storage.py:320)."""

    SCHEME = ''

    def __init__(self, bucket: str) -> None:
        if '/' in bucket:
            raise exceptions.StorageError(
                f'bucket name may not contain "/": {bucket!r}')
        self.bucket = bucket

    @property
    def url(self) -> str:
        return f'{self.SCHEME}://{self.bucket}'

    # subclass hooks ----------------------------------------------------------
    def _fake(self) -> Optional[str]:
        raise NotImplementedError

    def _real_exists(self) -> bool:
        raise NotImplementedError

    def _real_create(self, region: Optional[str]) -> None:
        raise NotImplementedError

    def _real_delete(self) -> None:
        raise NotImplementedError

    def _real_sync_up(self, src_dir: str, prefix: str,
                      excludes: List[str]) -> None:
        raise NotImplementedError

    def _real_sync_down(self, local_dir: str, prefix: str) -> None:
        raise NotImplementedError

    def _real_list_prefix(self, prefix: str) -> List[str]:
        raise NotImplementedError

    # shared ------------------------------------------------------------------
    def _local(self, prefix: str = '') -> str:
        root = self._fake()
        assert root is not None
        return os.path.join(root, self.bucket, prefix.lstrip('/'))

    def _url_prefix(self, prefix: str) -> str:
        return f'{self.url}/{prefix}'.rstrip('/')

    def exists(self) -> bool:
        if self._fake():
            return os.path.isdir(self._local())
        return self._real_exists()

    def create(self, region: Optional[str] = None) -> None:
        if self._fake():
            os.makedirs(self._local(), exist_ok=True)
            return
        self._real_create(region)

    def delete(self) -> None:
        if self._fake():
            shutil.rmtree(self._local(), ignore_errors=True)
            return
        self._real_delete()

    def sync_up(self, src_dir: str, prefix: str = '') -> None:
        """Upload a directory, honoring `.skyignore` at its root."""
        src_dir = os.path.expanduser(src_dir)
        excludes = storage_utils.load_excludes(src_dir)
        if self._fake():
            dst = self._local(prefix)
            for dirpath, _dirnames, filenames in os.walk(src_dir):
                for fname in filenames:
                    full = os.path.join(dirpath, fname)
                    rel = os.path.relpath(full, src_dir).replace(
                        os.sep, '/')
                    if storage_utils.excluded(rel, excludes):
                        continue
                    target = os.path.join(dst, rel)
                    os.makedirs(os.path.dirname(target), exist_ok=True)
                    shutil.copy2(full, target)
            return
        self._real_sync_up(src_dir, prefix, excludes)

    def sync_down(self, local_dir: str, prefix: str = '') -> None:
        local_dir = os.path.expanduser(local_dir)
        os.makedirs(local_dir, exist_ok=True)
        if self._fake():
            src = self._local(prefix)
            if os.path.isdir(src):
                shutil.copytree(src, local_dir, dirs_exist_ok=True)
            return
        self._real_sync_down(local_dir, prefix)

    def list_prefix(self, prefix: str = '') -> List[str]:
        if self._fake():
            base = self._local(prefix)
            out = []
            for dirpath, _d, filenames in os.walk(base):
                for fname in filenames:
                    rel = os.path.relpath(os.path.join(dirpath, fname),
                                          self._local())
                    out.append(rel.replace(os.sep, '/'))
            return sorted(out)
        return self._real_list_prefix(prefix)


class GcsStore(_BucketStore):
    """GCS bucket lifecycle + sync (parity: sky/data/storage.py GcsStore
    :2149 create/delete/upload).  Real path drives gsutil; with
    SKYTPU_FAKE_GCS_ROOT every op is a local file op on
    `$ROOT/<bucket>/` (see module docstring)."""

    SCHEME = 'gs'

    def _fake(self) -> Optional[str]:
        return _fake_root()

    def _gsutil(self, *args: str) -> subprocess.CompletedProcess:
        # skytpu: allow-unbounded-io(bulk upload/download: bounded by data size, not wall time)
        return subprocess.run(['gsutil', '-m', *args], check=False,
                              capture_output=True, text=True)

    def _real_exists(self) -> bool:
        return self._gsutil('ls', '-b', self.url).returncode == 0

    def _real_create(self, region: Optional[str]) -> None:
        args = ['mb']
        if region:
            args += ['-l', region]
        res = self._gsutil(*args, self.url)
        if res.returncode != 0 and 'already' not in res.stderr.lower():
            raise exceptions.StorageError(
                f'failed to create {self.url}: {res.stderr.strip()}')

    def _real_delete(self) -> None:
        res = self._gsutil('rm', '-r', self.url)
        if res.returncode != 0 and 'bucketnotfound' not in \
                res.stderr.lower().replace(' ', ''):
            raise exceptions.StorageError(
                f'failed to delete {self.url}: {res.stderr.strip()}')

    def _real_sync_up(self, src_dir: str, prefix: str,
                      excludes: List[str]) -> None:
        args = ['rsync', '-r']
        if excludes:
            # gsutil honors a single -x; OR the patterns into one regex.
            args += ['-x', '|'.join(fnmatch_to_re(p) for p in excludes)]
        res = self._gsutil(*args, src_dir, self._url_prefix(prefix))
        if res.returncode != 0:
            raise exceptions.StorageError(
                f'sync_up to {self.url} failed: {res.stderr.strip()}')

    def _real_sync_down(self, local_dir: str, prefix: str) -> None:
        res = self._gsutil('rsync', '-r', self._url_prefix(prefix),
                           local_dir)
        if res.returncode != 0:
            raise exceptions.StorageError(
                f'sync_down from {self.url} failed: {res.stderr.strip()}')

    def _real_list_prefix(self, prefix: str) -> List[str]:
        res = self._gsutil('ls', '-r', self._url_prefix(prefix))
        if res.returncode != 0:
            return []
        marker = f'{self.url}/'
        return sorted(line[len(marker):] for line in
                      res.stdout.splitlines()
                      if line.startswith(marker) and
                      not line.endswith(('/', ':')))


def fnmatch_to_re(pattern: str) -> str:
    """gsutil -x takes regexes; translate a glob conservatively."""
    import fnmatch as fnmatch_lib
    return fnmatch_lib.translate(pattern)
