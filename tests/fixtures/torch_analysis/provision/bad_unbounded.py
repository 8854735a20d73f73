"""Known-bad: a subprocess call without a timeout in control-plane
code (unbounded-io)."""
import subprocess


def run_remote(cmd):
    return subprocess.run(cmd, check=True)
