"""The port's fuse proxy (`skypilot_tpu_torch/data/fuse_proxy.py`, the
counterpart of the JAX package's): the same shim -> unix socket -> server
-> (fake) fusermount chain, with the /dev/fuse fd relayed back through
both hops via SCM_RIGHTS (tests/test_fuse_proxy.py's three cases and its
fake fusermount), on binaries the port builds from addons/fuse_proxy into
its own build tree.  The build is watched: every file the compiler writes
lies under the port's build directory, and addons/fuse_proxy/bin/ is the
same (or as absent) after the module as before it."""
import array
import os
import pathlib
import shutil
import socket
import stat
import subprocess

import pytest

import chip_smoke
from skypilot_tpu_torch.data import fuse_proxy
from test_fuse_proxy import FAKE_FUSERMOUNT

REPO = pathlib.Path(__file__).resolve().parents[1]
ADDON_BIN = REPO / 'addons' / 'fuse_proxy' / 'bin'
COMPILER_SHIM = '''#!/bin/sh
echo "$@" >> "$CXX_LOG"
exec {real} "$@"
'''


def listing(directory: pathlib.Path):
    """{name: (size, mtime_ns, inode)} of a directory, or None if it does
    not exist."""
    if not directory.exists():
        return None
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns, p.stat().st_ino)
            for p in directory.iterdir()}


@pytest.fixture(scope='module')
def build(tmp_path_factory):
    """A fresh build through the port's build(), with `g++` on PATH a shim
    that logs its arguments; the addon's bin/ listed first."""
    before = listing(ADDON_BIN)
    shims = tmp_path_factory.mktemp('cxx')
    log = shims / 'cxx.log'
    shim = shims / 'g++'
    shim.write_text(COMPILER_SHIM.format(real=shutil.which('g++')))
    shim.chmod(0o755)
    mp = pytest.MonkeyPatch()
    mp.setenv('PATH', f'{shims}{os.pathsep}{os.environ["PATH"]}')
    mp.setenv('CXX_LOG', str(log))
    try:
        bin_dir = fuse_proxy.build(force=True)
    finally:
        mp.undo()
    outputs = []
    for line in log.read_text().splitlines():
        args = line.split()
        outputs.append(args[args.index('-o') + 1])
    return {'bin_dir': bin_dir, 'outputs': outputs, 'before': before}


def test_binaries_live_under_the_port_build_dir(build):
    want = REPO / 'build' / 'skypilot_tpu_torch' / 'fuse_proxy'
    assert pathlib.Path(build['bin_dir']) == want
    assert fuse_proxy.ADDON_DIR == str(REPO / 'addons' / 'fuse_proxy')
    for path in (fuse_proxy.server_binary(), fuse_proxy.shim_binary()):
        assert pathlib.Path(path).parent == want
        assert os.access(path, os.X_OK)
    # Two binaries, each linked in a staging directory under the build
    # tree and renamed into place; the staging directory is gone.
    assert len(build['outputs']) == 2
    for out in build['outputs']:
        assert pathlib.Path(out).parent.parent == want, out
        assert not pathlib.Path(out).parent.exists()


@pytest.fixture
def proxy(build, tmp_path, monkeypatch):
    fake = tmp_path / 'fake-fusermount'
    fake.write_text(FAKE_FUSERMOUNT)
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    payload = tmp_path / 'payload.bin'
    payload.write_bytes(b'hello-from-dev-fuse')
    sock_path = tmp_path / 'fp.sock'
    fake_env = {'FAKE_LOG': str(tmp_path / 'argv.log'),
                'FAKE_PAYLOAD_FILE': str(payload),
                'FAKE_EXIT_FILE': str(tmp_path / 'exit.txt')}
    # The server forks the fake with its own environment.
    for key, value in fake_env.items():
        monkeypatch.setenv(key, value)
    server = fuse_proxy.FuseProxyServer(str(sock_path),
                                        fusermount_bin=str(fake))
    server.start()
    env = dict(os.environ, FUSE_PROXY_SOCKET=str(sock_path))
    env.pop('_FUSE_COMMFD', None)
    yield {'env': env, 'tmp': tmp_path}
    server.stop()


def _run_shim(env, extra_args, commfd=None):
    return subprocess.run([fuse_proxy.shim_binary()] + extra_args, env=env,
                          capture_output=True, timeout=60,
                          pass_fds=(commfd,) if commfd is not None else ())


def test_shim_relays_argv_exit_code_and_stderr(proxy):
    res = _run_shim(proxy['env'], ['-u', '/mnt/x'])
    assert res.returncode == 0
    assert b'fake-fusermount ran' in res.stderr
    logged = (proxy['tmp'] / 'argv.log').read_text().splitlines()
    assert logged == ['-u', '/mnt/x']


def test_shim_propagates_failure_exit(proxy):
    (proxy['tmp'] / 'exit.txt').write_text('3')
    try:
        res = _run_shim(proxy['env'], ['/mnt/y'])
    finally:
        (proxy['tmp'] / 'exit.txt').unlink()
    assert res.returncode == 3


def test_mount_fd_relayed_end_to_end(proxy):
    ours, theirs = socket.socketpair()
    env = dict(proxy['env'], _FUSE_COMMFD=str(theirs.fileno()))
    res = _run_shim(env, ['-o', 'rw', '/mnt/bucket'], commfd=theirs.fileno())
    theirs.close()
    assert res.returncode == 0, res.stderr
    ours.settimeout(30)
    _, ancdata, _, _ = ours.recvmsg(
        1, socket.CMSG_SPACE(array.array('i').itemsize))
    ours.close()
    assert ancdata, 'no fd arrived over _FUSE_COMMFD'
    fds = array.array('i')
    fds.frombytes(ancdata[0][2])
    data = os.read(fds[0], 64)
    os.close(fds[0])
    assert data == b'hello-from-dev-fuse'


def test_chip_smoke_fuse_relay_check(build, tmp_path):
    """chip_smoke.py's sub-step of its fleet phase, here on the CPU host:
    a fresh build into the same directory, argv and the fd relayed."""
    out = chip_smoke.fuse_relay_check(str(tmp_path))
    assert out['bin_dir'] == build['bin_dir']


@pytest.mark.parametrize('missing', ['make', 'g++'])
def test_build_raises_without_its_tools(build, tmp_path, monkeypatch,
                                        missing):
    """No fallback: with `make` or `g++` off PATH the build raises, and
    the binaries already built stay whole in place."""
    tools = tmp_path / 'bin'
    tools.mkdir()
    if missing == 'g++':
        (tools / 'make').symlink_to(shutil.which('make'))
    monkeypatch.setenv('PATH', str(tools))
    before = {name: pathlib.Path(build['bin_dir'], name).read_bytes()
              for name in ('fusermount-server', 'fusermount-shim')}
    with pytest.raises((FileNotFoundError, RuntimeError)) as err:
        fuse_proxy.build(force=True)
    assert missing in str(err.value)
    assert {name: pathlib.Path(build['bin_dir'], name).read_bytes()
            for name in before} == before
    assert [p.name for p in pathlib.Path(build['bin_dir']).iterdir()
            if p.name.startswith('.make-')] == []


def test_addon_bin_untouched(build):
    """Last in the module: nothing here created or changed
    addons/fuse_proxy/bin/."""
    assert listing(ADDON_BIN) == build['before']
