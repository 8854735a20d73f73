"""Storage object model: buckets mounted/copied into clusters.

Parity: sky/data/storage.py (Storage :560, AbstractStore :320, modes
:128, bucket lifecycle :560+).  GCS is the first-class store (TPU
clusters live in GCP; gcsfuse is preinstalled on TPU VMs); S3/R2 ride
the same interface via their CLIs.

Hermetic boundary for tests: with SKYTPU_FAKE_GCS_ROOT set,
`gs://bucket/...` maps to `$ROOT/bucket/...` and every operation —
lifecycle, sync, and MOUNT (a symlink standing in for gcsfuse) — is a
local file op.  Two local-cloud clusters that share nothing else can
then only exchange data through the "bucket", which is exactly the
property the managed-jobs checkpoint-recovery e2e proves.
"""
from __future__ import annotations

import dataclasses
import enum
import os
import shlex
import shutil
import subprocess
from typing import Dict, List, Optional, TYPE_CHECKING

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.data import storage_utils

if TYPE_CHECKING:
    from skypilot_tpu_torch.backends import tpu_vm_backend
    from skypilot_tpu_torch.global_user_state import ClusterHandle

logger = sky_logging.init_logger(__name__)


def _fake_root() -> Optional[str]:
    root = os.environ.get('SKYTPU_FAKE_GCS_ROOT')
    return os.path.expanduser(root) if root else None


def _fake_s3_root() -> Optional[str]:
    root = os.environ.get('SKYTPU_FAKE_S3_ROOT')
    return os.path.expanduser(root) if root else None


class StoreType(enum.Enum):
    GCS = 'gcs'
    S3 = 's3'
    R2 = 'r2'

    @classmethod
    def from_url(cls, url: str) -> 'StoreType':
        scheme = url.split('://', 1)[0]
        try:
            return {'gs': cls.GCS, 's3': cls.S3, 'r2': cls.R2}[scheme]
        except KeyError:
            raise exceptions.StorageError(
                f'Unsupported store URL scheme: {url}') from None


class StorageMode(enum.Enum):
    MOUNT = 'MOUNT'
    COPY = 'COPY'
    MOUNT_CACHED = 'MOUNT_CACHED'


@dataclasses.dataclass
class StorageMount:
    """One `file_mounts:` entry whose value is a storage config dict.

    Two shapes (reference task-YAML semantics):
      - `source: gs://bucket[/prefix]` — mount an existing bucket;
      - `name: my-bucket [, source: ./local_dir]` — framework-managed
        bucket: created if missing, local source uploaded, then mounted.
    """
    mount_path: str
    source: str                      # gs://bucket[/prefix] ('' if name-d)
    mode: StorageMode = StorageMode.MOUNT
    name: Optional[str] = None

    @classmethod
    def from_yaml_config(cls, mount_path: str,
                         config: Dict) -> 'StorageMount':
        source = config.get('source', '')
        name = config.get('name')
        if not source and not name:
            raise exceptions.StorageError(
                f'storage mount {mount_path!r} needs "source" or "name"')
        store = config.get('store')
        if store is not None:
            store = str(store).lower()
            try:
                StoreType(store)
            except ValueError:
                raise exceptions.StorageError(
                    f'storage mount {mount_path!r}: unknown store '
                    f'{config.get("store")!r}; expected one of '
                    f'{[s.value for s in StoreType]}') from None
        return cls(
            mount_path=mount_path,
            source=source,
            mode=StorageMode(config.get('mode', 'MOUNT').upper()),
            name=name,
            store=store,
        )

    store: Optional[str] = None      # 'gcs' (default) or 's3' for name-d

    def materialize(self) -> str:
        """Ensure the backing bucket exists (creating/uploading for
        name-managed mounts); returns the bucket URL to mount/copy."""
        if self.source.startswith(('gs://', 's3://', 'r2://')):
            return self.source
        if self.name is None:
            raise exceptions.StorageError(
                f'storage mount {self.mount_path!r}: a local source '
                f'({self.source!r}) needs "name" for the bucket to '
                'upload into')
        local_source = self.source or None
        store_type = StoreType(self.store) if self.store else StoreType.GCS
        Storage(self.name, source=local_source,
                store=store_type).materialize()
        scheme = {StoreType.S3: 's3', StoreType.R2: 'r2'}.get(
            store_type, 'gs')
        return f'{scheme}://{self.name}'


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


class S3Store(_BucketStore):
    """S3 bucket lifecycle + sync (parity: sky/data/storage.py S3Store
    :4502).  Real path drives the `aws s3` CLI (same CLI-driven shape as
    GcsStore/gsutil); with SKYTPU_FAKE_S3_ROOT every op is a local file
    op on `$ROOT/<bucket>/` — the same hermetic boundary the GCS fake
    provides."""

    SCHEME = 's3'

    def _fake(self) -> Optional[str]:
        return _fake_s3_root()

    def _aws(self, *args: str) -> subprocess.CompletedProcess:
        # skytpu: allow-unbounded-io(bulk upload/download: bounded by data size, not wall time)
        return subprocess.run(['aws', 's3', *args], check=False,
                              capture_output=True, text=True)

    @property
    def _cli_url(self) -> str:
        """The URL handed to the aws CLI (always s3://; R2 keeps its own
        r2:// in `url` for display/scheme routing)."""
        return f's3://{self.bucket}'

    def _cli_prefix(self, prefix: str) -> str:
        return f'{self._cli_url}/{prefix}'.rstrip('/')

    def _real_exists(self) -> bool:
        return self._aws('ls', self._cli_url).returncode == 0

    def _real_create(self, region: Optional[str]) -> None:
        args = ['mb', self._cli_url]
        if region:
            args += ['--region', region]
        res = self._aws(*args)
        if res.returncode != 0 and 'alreadyownedbyyou' not in \
                res.stderr.lower().replace(' ', ''):
            raise exceptions.StorageError(
                f'failed to create {self.url}: {res.stderr.strip()}')

    def _real_delete(self) -> None:
        res = self._aws('rb', self._cli_url, '--force')
        if res.returncode != 0 and 'nosuchbucket' not in \
                res.stderr.lower().replace(' ', ''):
            raise exceptions.StorageError(
                f'failed to delete {self.url}: {res.stderr.strip()}')

    def _real_sync_up(self, src_dir: str, prefix: str,
                      excludes: List[str]) -> None:
        args = ['sync', src_dir, self._cli_prefix(prefix)]
        for pat in excludes:                 # aws s3 takes globs directly
            args += ['--exclude', pat]
        res = self._aws(*args)
        if res.returncode != 0:
            raise exceptions.StorageError(
                f'sync_up to {self.url} failed: {res.stderr.strip()}')

    def _real_sync_down(self, local_dir: str, prefix: str) -> None:
        res = self._aws('sync', self._cli_prefix(prefix), local_dir)
        if res.returncode != 0:
            raise exceptions.StorageError(
                f'sync_down from {self.url} failed: {res.stderr.strip()}')

    def _real_list_prefix(self, prefix: str) -> List[str]:
        res = self._aws('ls', '--recursive', self._cli_prefix(prefix))
        if res.returncode != 0:
            return []
        return sorted(line.split(None, 3)[3]
                      for line in res.stdout.splitlines()
                      if len(line.split(None, 3)) == 4)


class R2Store(S3Store):
    """Cloudflare R2 (parity: sky/data/storage.py R2Store :4561).

    R2 speaks the S3 API behind an account endpoint: everything is the
    S3Store with ``--endpoint-url`` appended and s3:// CLI URIs (the
    aws CLI rejects r2://); config ``r2.endpoint_url`` or
    SKYTPU_R2_ENDPOINT_URL; credentials ride the standard AWS
    env/profile.  SKYTPU_FAKE_S3_ROOT covers R2 in tests the same way
    it covers S3 (one S3-compatible fake boundary).
    """

    SCHEME = 'r2'

    @staticmethod
    def _endpoint() -> Optional[str]:
        url = os.environ.get('SKYTPU_R2_ENDPOINT_URL')
        if url:
            return url
        from skypilot_tpu_torch import sky_config
        return sky_config.get_nested(('r2', 'endpoint_url'), None)

    def _aws(self, *args: str) -> subprocess.CompletedProcess:
        endpoint = self._endpoint()
        if not endpoint:
            raise exceptions.StorageError(
                'R2 needs an account endpoint: set r2.endpoint_url in '
                'config (or SKYTPU_R2_ENDPOINT_URL), e.g. '
                'https://<account_id>.r2.cloudflarestorage.com')
        # skytpu: allow-unbounded-io(bulk upload/download: bounded by data size, not wall time)
        return subprocess.run(
            ['aws', 's3', '--endpoint-url', endpoint, *args],
            check=False, capture_output=True, text=True)


def store_for_url(url: str):
    """gs://b -> GcsStore, s3://b -> S3Store, r2://b -> R2Store."""
    store_type = StoreType.from_url(url)
    bucket = url.split('://', 1)[1].split('/', 1)[0]
    if store_type is StoreType.GCS:
        return GcsStore(bucket)
    if store_type is StoreType.S3:
        return S3Store(bucket)
    if store_type is StoreType.R2:
        return R2Store(bucket)
    raise exceptions.StorageError(f'No store backend for {url}')


@dataclasses.dataclass
class Storage:
    """User-facing storage object: a (possibly framework-created) bucket
    plus an optional local source to upload (parity: Storage :560)."""
    name: str                                   # bucket name
    source: Optional[str] = None                # local dir to upload
    persistent: bool = True                     # survive `storage delete`?
    store: StoreType = StoreType.GCS            # backing provider

    def materialize(self):
        store = (S3Store(self.name) if self.store is StoreType.S3
                 else R2Store(self.name) if self.store is StoreType.R2
                 else GcsStore(self.name))
        if not store.exists():
            store.create()
        if self.source:
            store.sync_up(self.source)
        return store


def copy_command(source: str, dst: str) -> str:
    """CLI download command for COPY mode (parity: sky/cloud_stores.py)."""
    store = StoreType.from_url(source)
    q = shlex.quote
    if store is StoreType.GCS:
        root = _fake_root()
        if root is not None:
            src = os.path.join(root, source[len('gs://'):])
            return (f'mkdir -p {q(dst)} && mkdir -p {q(src)} && '
                    f'cp -a {q(src)}/. {q(dst)}/')
        return (f'mkdir -p {q(dst)} && '
                f'gsutil -m rsync -r {q(source)} {q(dst)}')
    if store in (StoreType.S3, StoreType.R2):
        root = _fake_s3_root()
        if root is not None:
            src = os.path.join(root, source.split('://', 1)[1])
            return (f'mkdir -p {q(dst)} && mkdir -p {q(src)} && '
                    f'cp -a {q(src)}/. {q(dst)}/')
        endpoint = ''
        s3_url = source
        if store is StoreType.R2:
            ep = R2Store._endpoint()  # pylint: disable=protected-access
            if not ep:
                raise exceptions.StorageError(
                    'R2 COPY needs r2.endpoint_url configured')
            endpoint = f'--endpoint-url {q(ep)} '
            s3_url = 's3://' + source[len('r2://'):]
        return (f'mkdir -p {q(dst)} && '
                f'aws s3 {endpoint}sync {q(s3_url)} {q(dst)}')
    raise exceptions.StorageError(f'COPY unsupported for {store}')


def mount_command(source: str, mount_path: str,
                  cached: bool = False) -> str:
    """FUSE mount command (parity: sky/data/mounting_utils.py:18-67;
    gcsfuse for GCS with MOUNT_CACHED via its file cache, goofys for S3
    with MOUNT_CACHED via rclone's VFS cache).  Under the fake roots a
    symlink into the fake root stands in for the FUSE mount — same
    contract (writes land in the bucket), no FUSE needed."""
    store = StoreType.from_url(source)
    q = shlex.quote
    if store is StoreType.GCS:
        bucket_and_prefix = source[len('gs://'):]
        root = _fake_root()
        if root is not None:
            target = os.path.join(root, bucket_and_prefix)
            return (f'mkdir -p {q(target)} && '
                    f'mkdir -p "$(dirname {q(mount_path)})" && '
                    f'ln -sfn {q(target)} {q(mount_path)}')
        bucket = bucket_and_prefix.split('/', 1)[0]
        flags = '--implicit-dirs'
        if cached:
            flags += (' --file-cache-max-size-mb -1 '
                      '--cache-dir ~/.skytpu/gcsfuse-cache')
        return (f'mkdir -p {q(mount_path)} && '
                f'(mountpoint -q {q(mount_path)} || '
                f'gcsfuse {flags} {q(bucket)} {q(mount_path)})')
    if store in (StoreType.S3, StoreType.R2):
        bucket_and_prefix = source.split('://', 1)[1]
        root = _fake_s3_root()
        if root is not None:
            target = os.path.join(root, bucket_and_prefix)
            return (f'mkdir -p {q(target)} && '
                    f'mkdir -p "$(dirname {q(mount_path)})" && '
                    f'ln -sfn {q(target)} {q(mount_path)}')
        bucket = bucket_and_prefix.split('/', 1)[0]
        endpoint_flag = ''
        if store is StoreType.R2:
            ep = R2Store._endpoint()  # pylint: disable=protected-access
            if not ep:
                raise exceptions.StorageError(
                    'R2 MOUNT needs r2.endpoint_url configured')
            endpoint_flag = f'--endpoint {q(ep)} '
        if cached:
            # rclone VFS write-back cache (ref mounting_utils rclone
            # path): survives re-reads without re-fetching.
            rclone_ep = (f'--s3-endpoint {q(ep)} '
                         if store is StoreType.R2 else '')
            return (f'mkdir -p {q(mount_path)} && '
                    f'(mountpoint -q {q(mount_path)} || '
                    f'rclone mount --daemon --vfs-cache-mode writes '
                    f'{rclone_ep}:s3:{q(bucket)} {q(mount_path)})')
        return (f'mkdir -p {q(mount_path)} && '
                f'(mountpoint -q {q(mount_path)} || '
                f'goofys {endpoint_flag}{q(bucket)} {q(mount_path)})')
    raise exceptions.StorageError(
        f'MOUNT supports gs://, s3:// and r2://, got {source}')


def fetch_bucket_to_cluster(backend: 'tpu_vm_backend.TpuVmBackend',
                            handle: 'ClusterHandle', source: str,
                            dst: str) -> None:
    """COPY-mode bucket fetch on every host (file_mounts with bucket URI)."""
    cmd = copy_command(source, dst)
    for runner in backend._host_runners(handle):  # pylint: disable=protected-access
        rc = runner.run(cmd)
        if rc != 0:
            raise exceptions.StorageError(
                f'bucket fetch failed on {runner.host}: {source}')


def mount_on_cluster(backend: 'tpu_vm_backend.TpuVmBackend',
                     handle: 'ClusterHandle', mount: StorageMount) -> None:
    """Materialize (bucket create + source upload) then mount/copy the
    storage onto every cluster host."""
    url = mount.materialize()
    mount_path = mount.mount_path
    if handle.cloud == 'local':
        # Local cloud: cluster-private paths live under the agent home
        # (same translation sync_file_mounts applies).
        mount_path = os.path.join(
            backend._agent_home(handle),  # pylint: disable=protected-access
            mount_path.lstrip('/~'))
    if mount.mode is StorageMode.COPY:
        return fetch_bucket_to_cluster(backend, handle, url, mount_path)
    cmd = mount_command(url, mount_path,
                        cached=mount.mode is StorageMode.MOUNT_CACHED)
    for runner in backend._host_runners(handle):  # pylint: disable=protected-access
        rc = runner.run(cmd)
        if rc != 0:
            raise exceptions.StorageError(
                f'mount failed on {runner.host}: {url}')


def mount_storage_mounts(backend: 'tpu_vm_backend.TpuVmBackend',
                         handle: 'ClusterHandle',
                         storage_mounts: Dict[str, Dict]) -> None:
    """Apply every `storage_mounts` entry of a task (launch stage)."""
    for mount_path, config in (storage_mounts or {}).items():
        mount_on_cluster(backend, handle,
                         StorageMount.from_yaml_config(mount_path, config))
