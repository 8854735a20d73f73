"""The port's cross-cloud transfer (`skypilot_tpu_torch/data/transfer.py`,
a copy of the JAX package's) held against the JAX package: each case runs
`transfer()` through both packages on fake store roots of their own
(`SKYTPU_FAKE_{GCS,S3,R2}_ROOT`) seeded alike, and compares the trees
that result (names and bytes), the errors (class and message), and the
relay's staging directory (gone afterwards, a failed upload included)."""
import os
import pathlib
import tempfile

import pytest

from skypilot_tpu.data import transfer as jax_transfer
from skypilot_tpu_torch.data import transfer as port_transfer

TRANSFERS = {'skypilot_tpu': jax_transfer,
             'skypilot_tpu_torch': port_transfer}
SEED_FILES = {'a.txt': b'alpha', 'b.txt': b'beta',
              'sub/w.bin': bytes(range(256)) * 64}


def tree(root) -> dict:
    """{path under root: bytes} of every file below `root`."""
    root = pathlib.Path(root)
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


def seed(directory, files=SEED_FILES):
    for name, data in files.items():
        path = pathlib.Path(directory) / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)


class Side:
    """One package's fake stores, local directory and private temp
    directory (where the relay makes its staging directory)."""

    def __init__(self, base: pathlib.Path, r2: bool) -> None:
        self.base = base
        self.roots = {'gs': base / 'gcs', 's3': base / 's3'}
        if r2:
            self.roots['r2'] = base / 'r2'
        self.local = base / 'local'
        self.tmp = base / 'tmp'
        for path in [*self.roots.values(), self.local, self.tmp]:
            path.mkdir(parents=True)

    def bucket(self, url: str) -> pathlib.Path:
        scheme, rest = url.split('://', 1)
        return self.roots[scheme] / rest

    def path(self, where: str) -> str:
        """A URL as it is, or a name under the local directory."""
        return where if '://' in where else str(self.local / where)

    def stores(self) -> dict:
        return {scheme: tree(root) for scheme, root in self.roots.items()}


def run_both(tmp_path, monkeypatch, src, dst, *, r2=False, prepare=None):
    """transfer(src, dst) through each package on its own Side, `src`
    seeded with SEED_FILES where it has a root; asserts both packages
    agree and returns the port's (outcome, side), where outcome is ('ok',
    None) or ('raise', class name, message)."""
    out = {}
    for pkg, module in TRANSFERS.items():
        side = Side(tmp_path / pkg, r2)
        env = {'gs': 'SKYTPU_FAKE_GCS_ROOT', 's3': 'SKYTPU_FAKE_S3_ROOT',
               'r2': 'SKYTPU_FAKE_R2_ROOT'}
        for scheme, name in env.items():
            if scheme in side.roots:
                monkeypatch.setenv(name, str(side.roots[scheme]))
            else:
                monkeypatch.delenv(name, raising=False)
        if '://' not in src:
            seed(side.local / src)
        elif src.split('://')[0] in side.roots:
            seed(side.bucket(src))
        if prepare is not None:
            prepare(side)
        monkeypatch.setattr(tempfile, 'tempdir', str(side.tmp))
        try:
            module.transfer(side.path(src), side.path(dst))
            outcome = ('ok', None)
        except Exception as e:  # pylint: disable=broad-except
            outcome = ('raise', type(e).__name__, str(e).replace(
                str(side.base), '<base>'))
        finally:
            monkeypatch.setattr(tempfile, 'tempdir', None)
        out[pkg] = (outcome, side)
    (jax_out, jax_side), (port_out, port_side) = out.values()
    assert port_out == jax_out
    assert port_side.stores() == jax_side.stores()
    assert tree(port_side.local) == tree(jax_side.local)
    for _, side in out.values():
        assert os.listdir(side.tmp) == [], 'the staging directory is left'
    return out['skypilot_tpu_torch']


@pytest.mark.parametrize('src,dst', [
    ('s3://src-bucket/data', 'gs://dst-bucket/data'),
    ('gs://gb/ckpt', 's3://sb/ckpt'),
    ('gs://gb/ckpt', 'gs://gb2/copy'),
])
def test_cross_scheme_relay_equals_jax(tmp_path, monkeypatch, src, dst):
    outcome, side = run_both(tmp_path, monkeypatch, src, dst)
    assert outcome == ('ok', None)
    assert tree(side.bucket(dst)) == SEED_FILES


def test_relay_through_fake_r2_equals_jax(tmp_path, monkeypatch):
    outcome, side = run_both(tmp_path, monkeypatch, 'r2://rb/w',
                             's3://sb/w', r2=True)
    assert outcome == ('ok', None)
    assert tree(side.bucket('s3://sb/w')) == SEED_FILES


def test_local_up_and_down_equals_jax(tmp_path, monkeypatch):
    outcome, side = run_both(tmp_path, monkeypatch, 'up', 'gs://lb/up')
    assert outcome == ('ok', None)
    assert tree(side.bucket('gs://lb/up')) == SEED_FILES
    outcome, side = run_both(tmp_path / 'down', monkeypatch, 's3://lb/d',
                             'down')
    assert outcome == ('ok', None)
    assert tree(side.local / 'down') == SEED_FILES


def test_local_to_local_equals_jax(tmp_path, monkeypatch):
    outcome, side = run_both(tmp_path, monkeypatch, 'from', 'to')
    assert outcome == ('ok', None)
    assert tree(side.local / 'to') == SEED_FILES


@pytest.mark.parametrize('src,dst', [
    ('r2://rb/w', 'gs://gb/w'),     # r2 download without an endpoint
    ('gs://gb/w', 'r2://rb/w'),     # r2 upload refused after the download
    ('up', 'r2://rb/w'),
])
def test_r2_without_endpoint_refused_as_jax(tmp_path, monkeypatch, src,
                                            dst):
    outcome, _ = run_both(tmp_path, monkeypatch, src, dst)
    assert outcome[:2] == ('raise', 'StorageError')
    assert 'r2' in outcome[2]


def test_unknown_scheme_refused_as_jax(tmp_path, monkeypatch):
    outcome, _ = run_both(tmp_path, monkeypatch, 'gs://b/c', 'ftp://x/y')
    assert outcome == ('raise', 'StorageError',
                       "unsupported transfer URL scheme 'ftp' (known: "
                       "('gs', 's3', 'r2'))")


def test_failed_upload_removes_the_staging_directory(tmp_path, monkeypatch):
    """The download lands in the staging directory, the upload fails (a
    file stands where the destination bucket's prefix should go); the
    staging directory is gone all the same (run_both checks it)."""
    def block(side):
        side.roots['s3'].joinpath('sb').write_text('not a directory')

    outcome, side = run_both(tmp_path, monkeypatch, 'gs://gb/ckpt',
                             's3://sb/ckpt', prepare=block)
    assert outcome[0] == 'raise'
    assert side.roots['s3'].joinpath('sb').read_text() == 'not a directory'
