"""Docker task runtime for VM hosts (parity: sky/provision/docker_utils.py
— the reference initializes a privileged container on each VM and runs
the task inside it; TPU VMs need --privileged for /dev/accel* access,
sky/clouds/gcp.py:545-546).

A task requests it with `image_id: docker:<image>` on VM-backed
resources (pods use the image directly — provision/kubernetes).  Flow:

- `bootstrap_command(image)` runs once per host at job-setup time: pull
  the image and start a long-lived container (sleep infinity) named
  `skytpu-ct`, with host networking (the gang rank env points peers at
  host IPs; the JAX coordinator must be reachable on them), /dev and
  the workdir bind-mounted, and --privileged so TPU device nodes work.
  Idempotent: an existing container of the same image is reused, a
  stale one (different image) is replaced.
- `wrap(cmd, env)` turns a host command into `docker exec` inside that
  container, exporting the env INSIDE the container (the gang's rank /
  coordinator contract must reach the task, not the docker client).

Counterpart of `skypilot_tpu/provision/docker_utils.py`: the same
container, commands and idempotence, but a task that asks for GPUs gets
`--gpus all` in place of `--privileged`.  On a TPU host the privileged
flag is what lets the task see its devices; on a GPU host that job is
done by `docker run --gpus all`, which hands the container the cards
and the driver's libraries through the NVIDIA container runtime.  A task
without GPUs gets the original's command, byte for byte.
"""
from __future__ import annotations

import shlex
from typing import Dict, Optional

CONTAINER_NAME = 'skytpu-ct'
DOCKER_PREFIX = 'docker:'


def image_from_resources(image_id: Optional[str]) -> Optional[str]:
    """The docker image a task asked for, or None (plain-VM task)."""
    if image_id and image_id.startswith(DOCKER_PREFIX):
        return image_id[len(DOCKER_PREFIX):]
    return None


def bootstrap_command(image: str,
                      workdir: Optional[str] = None,
                      gpus: bool = False) -> str:
    """Idempotent per-host container bootstrap (pull + run-or-reuse);
    `gpus` hands the container the host's cards (`--gpus all`)."""
    img = shlex.quote(image)
    name = CONTAINER_NAME
    mounts = '-v /dev:/dev'
    devices = '--gpus all' if gpus else '--privileged'
    workdir_flag = ''
    if workdir:
        wd = shlex.quote(workdir)
        mounts += f' -v {wd}:{wd}'
        workdir_flag = f'-w {wd} '
    return (
        # Reuse only a RUNNING container of the same image (a matching
        # but Exited one — host reboot, daemon restart — would make
        # every later docker exec fail); replace anything else.
        f'CUR=$(docker inspect '
        f'-f "{{{{.Config.Image}}}} {{{{.State.Running}}}}" {name} '
        f'2>/dev/null || true); '
        f'if [ "$CUR" != {shlex.quote(f"{image} true")} ]; then '
        f'  docker rm -f {name} >/dev/null 2>&1 || true; '
        f'  docker pull {img} && '
        f'  docker run -d {devices} --network=host --name {name} '
        f'  {mounts} {workdir_flag}{img} sleep infinity; '
        f'fi')


def wrap(cmd: str, env: Optional[Dict[str, str]] = None,
         workdir: Optional[str] = None) -> str:
    """Host command -> the same command inside the task container.

    Env is exported inside the container (docker exec -e would also
    work, but an export prefix keeps quoting uniform with the SSH
    runner's remote wrapper, utils/command_runner.py _remote_cmd)."""
    prefix = ''
    if env:
        prefix = ' && '.join(
            f'export {k}={shlex.quote(str(v))}' for k, v in env.items())
        prefix += ' && '
    if workdir:
        prefix += f'cd {shlex.quote(workdir)} && '
    return (f'docker exec {CONTAINER_NAME} '
            f'bash -c {shlex.quote(prefix + cmd)}')
