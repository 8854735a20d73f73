"""SSH keypair management (parity: sky/authentication.py).

One framework keypair (`~/.ssh/sky-key`) generated on first use.  The
public half reaches hosts per cloud at provision time:
  - GCP: `ssh-keys` instance/TPU-VM metadata (provision/gcp/instance.py)
  - AWS: cloud-init user_data appending to authorized_keys
    (provision/aws/instance.py)
  - SSH node pools: never injected — BYO hosts keep their own identity
    (ssh_node_pools.py)
and the backend's SSH runners authenticate with the private half.

Key ROTATION (`skytpu rotate-keys` / rotate_keys()): generate a fresh
pair, push the new public key onto every UP cluster's hosts over the
OLD key (authorized_keys append, idempotent), then atomically swap the
local files — newly provisioned hosts get the new key via the normal
metadata path, live clusters stay reachable throughout, and the old
private key is kept as a timestamped backup until the operator deletes
it.  (The reference has no rotation story; its authentication.py covers
distribution only.)
"""
from __future__ import annotations

import os
import shlex
import subprocess
import time
from typing import Dict, List, Tuple

from skypilot_tpu_torch import exceptions

PRIVATE_KEY_PATH = '~/.ssh/sky-key'
PUBLIC_KEY_PATH = '~/.ssh/sky-key.pub'


def _generate(priv: str) -> None:
    """Generate an ed25519 OpenSSH keypair at `priv`/`priv`.pub.

    Primary path is the `cryptography` library (no OpenSSH binaries
    needed — API-server containers are routinely that slim); falls back
    to ssh-keygen when cryptography is unavailable."""
    os.makedirs(os.path.dirname(priv), mode=0o700, exist_ok=True)
    try:
        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PrivateKey)
        key = Ed25519PrivateKey.generate()
        pem = key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.OpenSSH,
            serialization.NoEncryption())
        pub = key.public_key().public_bytes(
            serialization.Encoding.OpenSSH,
            serialization.PublicFormat.OpenSSH)
        fd = os.open(priv, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, 'wb') as f:
            f.write(pem)
        with open(priv + '.pub', 'wb') as f:
            f.write(pub + b' skytpu\n')
        return
    except ImportError:
        pass
    try:
        proc = subprocess.run(
            ['ssh-keygen', '-t', 'ed25519', '-N', '', '-q', '-f', priv,
             '-C', 'skytpu'],
            capture_output=True, check=False, timeout=60)
    except subprocess.TimeoutExpired as e:
        raise exceptions.SkyTpuError(
            'ssh-keygen timed out after 60s') from e
    if proc.returncode != 0:
        raise exceptions.SkyTpuError(
            f'ssh-keygen failed: {proc.stderr.decode()}')


def get_or_generate_keys() -> Tuple[str, str]:
    """Returns (private_key_path, public_key_str), generating if needed."""
    priv = os.path.expanduser(PRIVATE_KEY_PATH)
    pub = os.path.expanduser(PUBLIC_KEY_PATH)
    if not os.path.exists(priv):
        _generate(priv)
    with open(pub, encoding='utf-8') as f:
        return priv, f.read().strip()


def _append_key_cmd(pubkey: str) -> str:
    """Idempotent authorized_keys append (grep-before-append keeps
    repeated rotations from growing the file)."""
    q = shlex.quote(pubkey)
    return (f'mkdir -p ~/.ssh && chmod 700 ~/.ssh && '
            f'touch ~/.ssh/authorized_keys && '
            f'grep -qxF {q} ~/.ssh/authorized_keys || '
            f'echo {q} >> ~/.ssh/authorized_keys')


def rotate_keys() -> Dict[str, List[str]]:
    """Rotate the framework keypair across every UP cluster.

    Returns {'rotated': [...], 'skipped': [...]} on success.  The new
    public key is distributed over the OLD credentials first; the local
    swap happens ONLY if every cluster that depends on the framework key
    accepted it — a push failure, or a framework-keyed cluster that is
    not UP (its hosts cannot receive the key now, and a later restart
    does not re-inject metadata-delivered keys), ABORTS the rotation
    with nothing changed.  BYO-keyed clusters (ssh node pools) and the
    local cloud are skipped safely: they never held the framework key.
    """
    from skypilot_tpu_torch import global_user_state
    from skypilot_tpu_torch.backends import TpuVmBackend
    from skypilot_tpu_torch.global_user_state import ClusterStatus

    priv = os.path.expanduser(PRIVATE_KEY_PATH)
    pub = os.path.expanduser(PUBLIC_KEY_PATH)
    get_or_generate_keys()                       # ensure old pair exists
    new_priv = priv + '.rotating'
    for p in (new_priv, new_priv + '.pub'):
        if os.path.exists(p):
            os.unlink(p)
    _generate(new_priv)
    with open(new_priv + '.pub', encoding='utf-8') as f:
        new_pub = f.read().strip()

    def _ours(handle) -> bool:
        return not (handle.ssh_key_path and
                    os.path.abspath(os.path.expanduser(
                        handle.ssh_key_path)) != os.path.abspath(priv))

    backend = TpuVmBackend()
    rotated: List[str] = []
    skipped: List[str] = []
    blocking: List[str] = []
    for rec in global_user_state.get_clusters():
        name = rec['name']
        handle = rec['handle']
        if handle.cloud == 'local':
            rotated.append(name)                 # no SSH boundary
            continue
        if not _ours(handle):
            # BYO identity (ssh node pools): not ours to rotate.
            skipped.append(f'{name}: provider-managed key')
            continue
        if rec['status'] is not ClusterStatus.UP:
            blocking.append(f'{name}: {rec["status"].value} — its hosts '
                            f'cannot receive the new key (restart does '
                            f'not re-inject); start or down it first')
            continue
        try:
            cmd = _append_key_cmd(new_pub)
            for runner in backend._host_runners(handle):  # pylint: disable=protected-access
                rc = runner.run(cmd)
                if rc != 0:
                    raise exceptions.CommandError(
                        f'authorized_keys append failed on '
                        f'{runner.host} (rc={rc})')
            rotated.append(name)
        except Exception as e:  # pylint: disable=broad-except
            blocking.append(f'{name}: push failed: {e}')

    if blocking:
        # Nothing swapped: the old key is still the working credential
        # everywhere — retry once the listed clusters are UP (or down).
        for p in (new_priv, new_priv + '.pub'):
            if os.path.exists(p):
                os.unlink(p)
        raise exceptions.SkyTpuError(
            'key rotation ABORTED (no keys changed); resolve first:\n  '
            + '\n  '.join(blocking))

    # Swap: back up the old pair, promote the new one.
    stamp = time.strftime('%Y%m%d-%H%M%S')
    os.replace(priv, f'{priv}.{stamp}.bak')
    os.replace(pub, f'{pub}.{stamp}.bak')
    os.replace(new_priv, priv)
    os.replace(new_priv + '.pub', pub)
    return {'rotated': rotated, 'skipped': skipped}
