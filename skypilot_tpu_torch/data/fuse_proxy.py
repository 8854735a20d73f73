"""Python integration for the native fuse-proxy (addons/fuse_proxy).

The reference ships a Go fuse-proxy (addons/fuse-proxy: fusermount-shim
client masking `fusermount` + a privileged DaemonSet server over a unix
socket) so unprivileged k8s pods can FUSE-mount buckets
(addons/fuse-proxy/README.md:1-13).  Ours is C++ with the same
architecture; this module builds the binaries and manages a server for
tests/deployments.

Counterpart of `skypilot_tpu/data/fuse_proxy.py`: the same sources,
server and shim, but the binaries are built into the port's own ignored
build tree (`build/skypilot_tpu_torch/fuse_proxy/`, beside the kernel
library) and never into `addons/fuse_proxy/bin/`.  The original's
Makefile links straight onto `bin/fusermount-{server,shim}` and its
build() skips `make` once both paths exist, so two processes building
into one directory can execute a binary the other is still writing.
Here `make` writes into a private directory under the build tree
(`BIN_DIR=` on its command line overrides the Makefile's `bin`), and
each finished binary is renamed into place, so a path that exists is a
whole binary, even after a build that was killed mid-link.  Without
`make` or `g++` the build raises; nothing falls back.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

from skypilot_tpu_torch import sky_logging

logger = sky_logging.init_logger(__name__)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ADDON_DIR = os.path.join(_REPO, 'addons', 'fuse_proxy')
BIN_DIR = os.path.join(_REPO, 'build', 'skypilot_tpu_torch', 'fuse_proxy')
_BINARIES = ('fusermount-server', 'fusermount-shim')


def build(force: bool = False) -> str:
    """`make` the shim+server into the port's build tree; returns the bin
    dir."""
    if not force and all(os.path.exists(os.path.join(BIN_DIR, name))
                         for name in _BINARIES):
        return BIN_DIR
    os.makedirs(BIN_DIR, exist_ok=True)
    staging = tempfile.mkdtemp(prefix='.make-', dir=BIN_DIR)
    try:
        proc = subprocess.run(['make', '-C', ADDON_DIR, f'BIN_DIR={staging}'],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f'fuse-proxy build failed ({proc.returncode}):\n'
                f'{proc.stdout[-2000:]}{proc.stderr[-2000:]}')
        for name in _BINARIES:
            os.replace(os.path.join(staging, name),
                       os.path.join(BIN_DIR, name))
    finally:
        shutil.rmtree(staging, ignore_errors=True)
    return BIN_DIR


def server_binary() -> str:
    return os.path.join(build(), 'fusermount-server')


def shim_binary() -> str:
    return os.path.join(build(), 'fusermount-shim')


class FuseProxyServer:
    """Run a fusermount-server on a socket (tests / single-host use; on
    k8s the server is a privileged DaemonSet from the same binary)."""

    def __init__(self, socket_path: str,
                 fusermount_bin: str = 'fusermount') -> None:
        self.socket_path = socket_path
        self.fusermount_bin = fusermount_bin
        self._proc: Optional[subprocess.Popen] = None

    def start(self, timeout_s: float = 10.0) -> None:
        self._proc = subprocess.Popen(
            [server_binary(), '--socket', self.socket_path,
             '--fusermount', self.fusermount_bin],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if os.path.exists(self.socket_path):
                return
            time.sleep(0.05)
        raise RuntimeError('fuse-proxy server did not come up')

    def stop(self) -> None:
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
            self._proc = None
